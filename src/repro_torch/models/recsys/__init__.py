"""Recommendation models of the port: two-tower retrieval."""
