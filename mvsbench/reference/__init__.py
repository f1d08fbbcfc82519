"""The plain PyTorch reference that decides `correct`; imports torch alone."""
