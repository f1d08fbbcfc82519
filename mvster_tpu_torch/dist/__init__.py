"""The train and eval steps (one device)."""
