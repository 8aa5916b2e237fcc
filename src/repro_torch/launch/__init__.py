"""Step functions (train, prefill, decode), the cells that lay them out on
a mesh, the production meshes and the dry run."""
