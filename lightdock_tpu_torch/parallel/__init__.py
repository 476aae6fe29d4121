"""Multi-swarm runs of the port: the swarm farm on one GPU (``farm``) and
the stacking, random draws and snapshot writing it shares (``multihost``)."""
