"""Distribution of the port: the sharding rules and the collectives the
sharded train step computes with (``sharding``), elastic re-meshing
(``elastic``) and GPipe stages (``pipeline``), over ``torch.distributed``."""
