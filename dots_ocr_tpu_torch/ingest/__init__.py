"""Ingestion: PDF rasterization and image DPI normalization."""
