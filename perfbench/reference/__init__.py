"""The plain reference that decides ``correct``: NumPy in float64, with the
lower-precision control beside it.  It imports neither JAX, nor the JAX
package, nor anything of the port, and works everything out again from
the inputs the harness generated: the symmetrized graph, the degrees and
the Laplacian scaling, the class weights, Z, the class cells and the
probe."""
