"""The FlexPipe controller plane (paper §4–§7): the graph and partitioner
(Eq. 2–3), the CV monitor and granularity selection (Alg. 1, Eq. 4–5),
allocation (Eq. 6–9), inflight refactoring (Eq. 10), scaling, the resource
graph and affinity (Eq. 11–13), and ``FlexPipeController``, which composes
them."""
