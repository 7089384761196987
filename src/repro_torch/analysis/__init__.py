"""Correctness tooling: KV-lifecycle sanitizer, repo lint, kernel checks.

The port of the reference's ``analysis`` package. Three checkers over the
serving stack's most fragile shared contract — the paged-KV block
lifecycle — plus the repo-specific static rules:

  * ``sanitizer``   — a shadow BlockManager mirroring every
    allocate/extend/commit/free/evict/spill/restore/migrate event
    (``Engine(sanitize=True)`` / ``REPRO_SANITIZE=1``);
  * ``lint``        — AST-based repo lint (``python -m
    repro_torch.analysis.lint``) with a ratcheting baseline of its own;
  * ``kernelcheck`` — pre-launch validation of the Hopper attention
    kernels' contracts (shapes, GQA grouping, int8 quant leaves, head
    dims and dtypes the kernels take, int32 indices, 16-byte page starts,
    and the index values), run from ``kernels/ops.py`` dispatch in
    sanitize mode.

Nothing here sits on a hot path unless explicitly enabled: every
instrumentation point in serving/ is a ``if self.tracer is not None``
guard around an attribute that defaults to ``None``, and dispatch tests
one flag before it calls ``kernelcheck``.
"""
