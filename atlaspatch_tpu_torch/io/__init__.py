"""Slide access: WSI abstraction, plain-image and synthetic slides, backend
factory, native geometry bindings."""
