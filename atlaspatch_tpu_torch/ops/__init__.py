"""Compute ops: attention kernel, the int8 linear, polygon containment, contours,
content filters, resizing."""
