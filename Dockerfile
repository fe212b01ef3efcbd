# tpufft runtime image (role of the reference's Dockerfile/docker-compose:
# a reproducible environment for tests and benchmarks). Built on a CUDA
# base so JAX's CUDA wheel finds the driver libraries; the same image runs
# the CPU test suite (tests/conftest.py pins the CPU) and, on a host with an
# NVIDIA GPU (docker run --gpus all), chip_smoke.py and the benchmarks.
FROM nvidia/cuda:12.4.1-cudnn-runtime-ubuntu22.04

RUN apt-get update && apt-get install -y --no-install-recommends \
        python3 python3-pip g++ make libfftw3-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/tpufft
COPY pyproject.toml setup.py MANIFEST.in README.md ./
COPY tpufft ./tpufft
COPY native ./native
COPY tests ./tests
COPY harness.py bench.py bench_suite.py profile.py chip_smoke.py \
     __graft_entry__.py ./

# jax[cuda12] brings the CUDA plugin; pyfftw adds the FFTW_MEASURE column
# of bench_suite.py --device cpu (the reference's
# benchmark-cpu-others/benchmark.py:52-57 harness).
RUN pip install --no-cache-dir "jax[cuda12]" numpy scipy pytest \
        pytest-xdist pyfftw && \
    pip install --no-cache-dir -e .

CMD ["python3", "-m", "pytest", "tests/", "-q"]
