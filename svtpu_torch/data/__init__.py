"""Host-side data utilities of the port."""
