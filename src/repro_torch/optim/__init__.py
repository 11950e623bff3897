"""AdamW with global-norm clipping and a cosine schedule."""
