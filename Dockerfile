# Deployment image for sypha (counterpart of the reference's nvidia/cuda
# devel image + compose file).  The NVIDIA driver comes from the host
# through the NVIDIA container toolkit; JAX's CUDA 12 plugin brings the
# CUDA runtime libraries.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY . /app

# `make` builds the native host library under the same keyed name that
# sypha.native loads (a different CPU at run time triggers a rebuild)
RUN pip install --no-cache-dir "jax[cuda12]" numpy scipy && make

ENTRYPOINT ["python", "-m", "sypha"]
CMD ["--model", "SCP", "--input-file", "data/demo_small.txt", "--verbosity", "3"]
