"""Layers, attention and audio helpers; ``ops.cuda`` holds the kernels."""
