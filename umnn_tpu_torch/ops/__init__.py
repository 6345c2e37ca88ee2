"""Quadrature and the fused integrand kernel."""
