"""Plain float32 PyTorch reference of the VideoITG grounding model (no port code)."""
