"""Measurement helpers of the port."""
