"""Host-side (numpy) data pipeline of the port."""
