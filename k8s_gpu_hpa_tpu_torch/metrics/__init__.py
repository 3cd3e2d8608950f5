"""Metric schema, text exposition, TSDB and scraper, recording rules (L3)."""
