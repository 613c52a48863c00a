"""Data-parallel helpers: gradient compression over a mesh's ``data`` axis."""
