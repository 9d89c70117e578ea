"""Runtime guards of the port (:mod:`.runtime`): the cold-path budget that
``SearchEngine.warmup`` is held to. The reference's static jit/Pallas
lints have no counterpart here (``ROADMAP.md`` queue A)."""
