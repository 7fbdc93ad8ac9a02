"""Didactic, self-contained examples."""
