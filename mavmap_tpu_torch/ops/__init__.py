"""Geometry operators: matching, estimators, triangulation."""
