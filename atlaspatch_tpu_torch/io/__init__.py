"""Slide access: WSI abstraction, synthetic slide, native geometry bindings."""
