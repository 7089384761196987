"""Distribution of the port: the logical-axis sharding rules
(``sharding``), mapped onto ``torch.distributed``'s ``DeviceMesh``."""
