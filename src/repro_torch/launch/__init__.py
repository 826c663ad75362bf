"""Launchers: process groups and device meshes (mesh.py), the paper's
pipeline (cluster.py), the serving stack end to end (serve_cluster.py)
and the decoder-only LMs' prefill / decode (serve.py, its inputs in
specs.py) from the command line."""
