"""Meshes, partition rules and process-group set-up (the port of
``svtpu/parallel``)."""
