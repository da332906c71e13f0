"""The mesh layer: DTensor placements on a named ``DeviceMesh``."""
