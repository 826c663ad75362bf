"""Launchers: process groups and device meshes (mesh.py), the paper's
pipeline (cluster.py) and the serving stack end to end (serve_cluster.py)
from the command line."""
