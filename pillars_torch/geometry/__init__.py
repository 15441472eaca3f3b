"""Box geometry: torch ops for the postprocess, NumPy for anchors."""
