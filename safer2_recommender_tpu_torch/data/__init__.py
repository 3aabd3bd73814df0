"""Bucketed data layer."""
