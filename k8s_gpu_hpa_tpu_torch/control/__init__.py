"""Custom-metrics adapter (L4) and HPA controller (L5)."""
