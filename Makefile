# Convenience targets (the analog of the reference's top-level CMake
# workflow; the Python package itself needs no build step).

.PHONY: all native test smoke bench ubench lint clean

all: native

native: native/libndzip_cpu.so native/libndzip_competitors.so

native/libndzip_cpu.so: native/ndzip_cpu.cc
	$(CXX) -O3 -march=native -funroll-loops -std=c++17 -shared -fPIC -pthread $< -o $@

native/libndzip_competitors.so: native/competitors.cc
	$(CXX) -O3 -march=native -funroll-loops -std=c++17 -shared -fPIC -pthread $< -o $@

# CMake variant of the native build
native-cmake:
	cmake -S native -B native/build -G Ninja && cmake --build native/build

test: native
	python -m pytest tests/ -x -q

# The codec on the GPU at full size, every entry point, streams checked
# against golden.py.  One JAX process per card: not beside bench.
smoke:
	python chip_smoke.py

lint:
	python -m compileall -q ndzip_jax tests examples
	python -m pyflakes ndzip_jax tests examples 2>/dev/null || true

bench: native
	python bench.py

ubench:
	python -m ndzip_jax.ubench

clean:
	rm -f native/libndzip_cpu.so
	rm -rf native/build
