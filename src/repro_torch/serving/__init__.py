"""Continuous-batching serving over the port's models."""
