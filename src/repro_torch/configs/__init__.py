"""Workload configurations."""
