"""Cluster catalog and workload generators (numpy)."""
