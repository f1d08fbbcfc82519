"""Weight loading and the inference tool."""
