PY ?= python
export PYTHONPATH := src

.PHONY: test test-torch test-quick obs-smoke chaos-smoke bench bench-quick bench-formats bench-affinity bench-gate

test:            ## full tier-1 suite (ROADMAP verify command)
	$(PY) -m pytest -x -q

test-torch:      ## the PyTorch/CUDA port's parity tests (CPU; `cuda`-marked tests skip)
	$(PY) -m pytest -q tests/test_torch_*.py

test-quick:      ## BFS substrate + engine + formats + API (fast inner loop)
	$(PY) -m pytest -x -q tests/test_bitmap.py tests/test_kernels.py \
	    tests/test_bfs_correctness.py tests/test_engine.py \
	    tests/test_formats.py tests/test_gather_pipeline.py \
	    tests/test_packed_engine.py tests/test_plan_api.py \
	    tests/test_api_surface.py tests/test_megakernel.py \
	    tests/test_persistent.py tests/test_obs.py \
	    tests/test_serve_robust.py tests/test_graph_validation.py
	$(MAKE) obs-smoke
	$(MAKE) chaos-smoke

obs-smoke:       ## end-to-end obs contract (trace JSON + serve metrics)
	$(PY) -m benchmarks.obs_smoke

chaos-smoke:     ## serve robustness under fault injection (zero lost queries)
	$(PY) -m benchmarks.chaos_smoke

bench:           ## full benchmark harness
	$(PY) -m benchmarks.run

bench-quick:     ## batched + formats + layer/bytes + packed + plan-cache probes (updates BENCH_bfs.json)
	$(PY) -m benchmarks.run --quick --only bfs_batched
	$(PY) -m benchmarks.run --quick --only bfs_formats
	$(PY) -m benchmarks.run --quick --only bfs_layers
	$(PY) -m benchmarks.run --quick --only bfs_packed
	$(PY) -m benchmarks.run --quick --only bfs_plan_cache
	$(PY) -m benchmarks.run --quick --only bfs_megakernel
	$(PY) -m benchmarks.run --quick --only bfs_persistent
	$(PY) -m benchmarks.run --quick --only bfs_algorithms

bench-formats:   ## the graph-format sweep (TEPS + bytes per layout)
	$(PY) -m benchmarks.run --only bfs_formats

bench-affinity:  ## regenerate the geometry-keyed autotune table rows
	$(PY) -m benchmarks.run --only affinity

bench-gate:      ## CI: fused bytes-moved vs committed BENCH_bfs.json
	$(PY) -m benchmarks.check_bytes_regression
