"""Logging, progress, phase timing and provenance helpers."""
