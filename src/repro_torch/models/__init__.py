"""Model code of the port: layers and the dense transformer."""
