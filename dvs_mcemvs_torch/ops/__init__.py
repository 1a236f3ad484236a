"""Array operations of the port: geometry, voting, fusion, extraction."""
