"""Model classes of the port."""
