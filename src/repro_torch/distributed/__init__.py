"""Distribution of the port: the logical-axis sharding rules
(``sharding``), mapped onto ``torch.distributed``'s ``DeviceMesh``; the
manual tensor-parallel prefill (``manual_tp``) and the pipelined prefill
(``pp_spmd``) on ``torch.distributed`` process groups."""
