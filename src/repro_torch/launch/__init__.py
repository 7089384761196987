"""The dry run of every (arch x shape) cell on the production meshes:
meshes (``mesh``), per-cell specs (``specs``) and the sweep (``dryrun``)."""
