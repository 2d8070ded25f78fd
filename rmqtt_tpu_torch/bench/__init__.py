"""Workload generators shared by the port's smoke run and tests."""
