"""Device math of the port: kernel design, the overlap-save plan and
filters, and the CUDA segment-filter kernel with its plain version.

Nothing is imported here eagerly; import the submodules."""
