"""Experimental APIs (reference: ray.experimental)."""

from . import channel  # noqa: F401

__all__ = ["channel"]
