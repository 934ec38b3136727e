"""Launch helpers: the step's cost, its roofline, meshes and the training
CLI."""
