"""Logging and parameter-tree helpers."""
