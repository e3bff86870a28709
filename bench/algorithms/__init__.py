"""One file an algorithm, found by the traffic mix's ``"algorithm"``. Each
holds the plain reference (torch only: nothing of the program), the
control that stands in the program's place to show the comparison can
fail, the comparison itself, and ``sending_edges``: the edges each
superstep of a job has to send along, which the kernel rooflines count
bytes from. Every function takes the benchmark's own (E, 2) edges on the
device, the vertex count and the job's arguments."""
