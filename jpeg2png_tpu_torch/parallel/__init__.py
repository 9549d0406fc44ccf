"""Row-striped solves: one image's rows in bands over several devices or
processes (mesh.py, distributed.py, stripes.py)."""
