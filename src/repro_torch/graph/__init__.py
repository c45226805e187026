"""Graph containers, ELL packing and the graph generators."""
