"""The benchmark of ``repro_torch``: GAP graphs, Graph500 search keys,
batched and single searches and the BFS query service, on one GPU.

Run from the checkout's root: ``python3 -m graphbench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``."""
