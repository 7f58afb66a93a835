"""The packed scheduling solve on PyTorch and an NVIDIA Hopper card.

A port of the device half of ``evergreen_tpu``: the snapshot layout, the
batched solve (planner, allocator, capacity + affinity), the solver
sidecar and solver-leader plane, the whole scheduler tick from a store
(gather, snapshot, bounded solve, unpack, capacity plane, persister),
the service's tick (TickCache, resident plane, device mirror) on the
in-memory or the durable store (WAL, replay, epoch fencing), and the
sharded plane over N shard stores, durable or not, and the host planes
around the tick (the job plane, the REST agent surface, the agent and
the ingestion plane that turns revisions, patches and merge groups into
versions, builds and tasks). It
imports ``torch`` and numpy and nothing of ``evergreen_tpu`` or JAX.
Entry points (``ops.solve.run_solve_packed``,
``ops.capacity.run_capacity_solve``, ``api.sidecar.serve``,
``python -m evergreen_tpu_torch solver``) run on the CUDA card unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
