"""Numerical ops of the port (channels-last ``[B, T, C]``)."""
