"""Device math of the port: kernel design, the overlap-save plan and
filters, and the CUDA kernels (segment filter, block convolution) with
their plain versions.

Nothing is imported here eagerly; import the submodules."""
