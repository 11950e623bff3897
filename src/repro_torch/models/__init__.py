"""Model families of the port (the dense decoder in this slice)."""
