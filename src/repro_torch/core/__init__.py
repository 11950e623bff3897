"""Accumulation strategies across ranks (``collectives``) and the NoC cost
model that chooses between them (``noc``)."""
