"""Multi-swarm runs of the port: the swarm farm (``farm``), the mesh of
``torch.distributed`` ranks (``mesh``), swarms and receptor atoms split
over it (``sharded``), and the stacking, random draws, snapshot writing
and process start they share (``multihost``)."""
