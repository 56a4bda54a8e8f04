"""Compute ops: attention kernel, polygon containment, contours."""
