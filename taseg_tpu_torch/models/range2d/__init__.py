"""2D range-view blocks of the port (RPVNet's range branch)."""
