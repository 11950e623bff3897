"""Tensor-parallel linears and the serve/prefill steps of the port."""
