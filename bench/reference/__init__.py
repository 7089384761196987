"""Architecture modules: everything of the benchmark that depends on a
model's shape, one module an architecture. A configuration file names
its module by the key ``"reference"`` (``bench/reference/<name>.py``);
without the key it is ``model``, the plain decoder. The harness calls
the module and names no architecture, so a configuration brings a new
architecture to the benchmark in new files alone.

Every module exports, ``arch`` being the configuration file's dict:

``port_config(arch)``
    The port's ``ModelConfig``: the file's keys, as run, mapped onto the
    port's fields.
``layout(arch)``
    path -> (shape, kind, std) of every leaf of the port's parameters,
    in the order the weights are drawn from the seed; kind is "matrix",
    "embed", "norm" or "bias" (``bench/harness/weights.py`` draws them).
``logits_at(arch, weights, seq, rows, quant=None)``
    The plain reference: float32 logits (len(rows), vocab) at positions
    ``rows`` of ``seq``; ``quant="fp8"`` is the control, the same forward
    in float8 products. Plain PyTorch: it imports nothing of the program
    and reads nothing the program made.
``token_flops(arch, ctx, logits)``, ``span_flops(arch, pos0, n, logits)``
    Model FLOPs of one token against ``ctx`` keys, and of ``n`` prompt
    tokens from position ``pos0`` (the head once when ``logits``).
``memory(arch, engine_stats, held_blocks)``
    What the deployment holds on the card, in bytes: ``weights_bytes``,
    ``kv_pool_bytes`` (the pool as reserved; ``engine_stats`` is the
    endpoint's ``stats()``) and ``kv_live_peak_bytes`` (``held_blocks``
    pages); a module may add entries, such as recurrent state.
``CALLS``
    Entry point of ``repro_torch.kernels.ops`` -> cost function. A traced
    run wraps each entry point named here; each call is recorded as
    ``cost(arch, ctx, *args, **kwargs)`` -> (family, bytes, flops), where
    ``ctx.spans`` is [(pos0, n)] of the runner's current prefill or
    ragged forward and ``ctx.kv_lens`` the rows' ``kv_len`` of its
    current decode. A roofline metric reads a family.

A module may build on another's public pieces (``model``'s leaves and
layers)."""
