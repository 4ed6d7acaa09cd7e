import os

# The suite runs on JAX's CPU platform with 8 virtual devices, so the
# sharding paths are exercised without a GPU.  The program itself runs on
# the GPU through chip_smoke.py and bench.py, one JAX process per card.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_NUM_CPU_DEVICES"] = "8"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"  # for subprocesses too

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# Importing the codec points JAX's persistent compilation cache at a
# directory; the suite's workers compile for themselves instead of sharing
# executables through files they write concurrently.  The cache tests turn
# it back on where they need it.
jax.config.update("jax_enable_compilation_cache", False)
