# Top-level targets (analog of the reference's Makefile glue).

.PHONY: all native test test-quick test-gpu lint bench chip-smoke docs clean

all: native

native:
	$(MAKE) -C biseqt_jax/native

test: native
	python -m pytest tests/ -x -q

# inner-loop suite: skips the slow mesh-engine and genome-shape tests
test-quick: native
	python -m pytest tests/ -x -q -m "not slow"

# the card-only tests (CUDA kernel vs the lax engine); on a GPU host,
# one process
test-gpu: native
	JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu -p no:xdist

# no flake8/pyflakes in this environment: compile-check every source file
# (catches syntax errors and is a real failure, not a no-op)
lint:
	python -m compileall -q biseqt_jax tests experiments bench.py \
	  chip_smoke.py __graft_entry__.py

bench:
	python bench.py

# the main path on one GPU against the repo's references (one process;
# `python chip_smoke.py --four` runs the four-card phase)
chip-smoke: native
	python chip_smoke.py

# API reference: sphinx if installed (the reference's doc stack),
# otherwise the stdlib docstring->markdown generator
docs:
	@python -c "import sphinx" 2>/dev/null \
	  && sphinx-build -b html docs docs/_build \
	  || python docs/gen_api.py

clean:
	$(MAKE) -C biseqt_jax/native clean
	rm -rf .pytest_cache .jax_cache __pycache__
