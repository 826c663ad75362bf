"""Launchers: process groups and device meshes (mesh.py), and the paper's
pipeline from the command line (cluster.py)."""
