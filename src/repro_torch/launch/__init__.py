"""Process-group and device-mesh set-up for the mesh plan."""
