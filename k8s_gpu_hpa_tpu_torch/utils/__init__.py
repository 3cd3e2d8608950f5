"""Host-side helpers: clocks and the native build."""
