"""Host-side asset scanning and byte packing."""
