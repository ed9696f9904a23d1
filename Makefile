# Top-level targets, mirroring the reference's Makefile-driven workflow
# (code/Makefile, lanl-implementation/Makefile) with pytest/python instead
# of mpiexec wrappers.

.PHONY: test native bench bench-sweep demo clean

test: native
	python -m pytest tests/ -q

native:
	$(MAKE) -C native

bench:
	python bench.py

bench-sweep:
	python benchmarks/run_single.py --sizes 64,128,256 --out chiprun_out/single.json

demo:
	python examples/demo_single.py 64 4
	python examples/demo_distributed.py

clean:
	$(MAKE) -C native clean
	rm -rf .jax_cache
