"""GENEO kernel synthesis."""
