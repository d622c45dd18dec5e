# Developer entry points (the reference's justfile equivalents)

.PHONY: test test-fast test-card smoke bench tables multihost-demo fuzz

# randomized differential fuzz of the shard/seam merge (CPU, vs oracle)
fuzz:
	python tools/fuzz_shards.py

# CPU suite (8 virtual devices, see tests/conftest.py)
test:
	python -m pytest tests/ -x -q

test-fast:
	python -m pytest tests/test_golden.py tests/test_oracle.py tests/test_sweep.py -q

# on a GPU: the card-only checks, the smoke test, the headline benchmark
test-card:
	JAX_PLATFORMS=cuda python -m pytest -m card tests/test_card.py -q

smoke:
	python chip_smoke.py

bench:
	python bench.py

tables:
	python bench/eval.py results.json

# two JAX processes on one machine, 4 virtual CPU devices each:
# exercises jax.distributed + process_allgather in parallel/multihost.py
multihost-demo:
	python examples/multihost_demo.py
