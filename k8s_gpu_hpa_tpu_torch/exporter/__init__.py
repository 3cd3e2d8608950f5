"""The metrics exporter (L2): device sources, the C++ core's binding, the daemon."""
