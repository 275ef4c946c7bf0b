# Deploy image — the reference ships a fat-jar container the same way
# (/root/reference/Dockerfile: jdk builder -> jar-with-dependencies);
# here the artifact is the installed package + the prebuilt native
# decoder, with the CLI as the entrypoint.
#
#   docker build -t colormipsearch-tpu .
#   docker run --rm colormipsearch-tpu colorDepthSearch --help
#
# For NVIDIA GPU hosts install the CUDA extra instead of CPU jax:
#   docker build --build-arg JAX_EXTRA=cuda -t colormipsearch-tpu:cuda .

FROM python:3.12-slim AS builder
ARG JAX_EXTRA=""

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /src
COPY pyproject.toml ./
COPY colormipsearch_tpu ./colormipsearch_tpu
COPY native ./native

# prebuild the native TIFF/PNG batch decoder so first use never
# compiles inside the runtime container (io/native_decoder.py falls
# back to building into its artifact cache otherwise)
RUN make -C native \
    && mkdir -p /opt/cmtpu-native \
    && cp native/libcdmdecoder.so /opt/cmtpu-native/

RUN pip install --no-cache-dir .${JAX_EXTRA:+[$JAX_EXTRA]}

FROM python:3.12-slim

COPY --from=builder /usr/local/lib/python3.12/site-packages \
    /usr/local/lib/python3.12/site-packages
COPY --from=builder /usr/local/bin/colormipsearch-tpu \
    /usr/local/bin/colormipsearch-tpu
COPY --from=builder /opt/cmtpu-native /opt/cmtpu-native

# the decoder loader picks up the prebuilt .so from the artifact cache
# (utils/caches.py; io/native_decoder.py installed-without-source path)
ENV COLORMIPSEARCH_TPU_CACHE=/opt/cmtpu-native
# persistent XLA compilation cache across container runs (mount it)
ENV JAX_COMPILATION_CACHE_DIR=/cache/jax
VOLUME ["/cache"]

WORKDIR /data
ENTRYPOINT ["colormipsearch-tpu"]
