"""Synthetic workloads and the golden accuracy fixture of the port."""
