"""The general generators, one per kind of traffic. A traffic file's
`driver` names one of these modules; the module's `Driver(run)` builds the
cell's inputs from the seed and the traffic's parameters, sets the program
up (`setup`), drives the measured window (`window`) or the traced one
(`trace_window`), and compares what the timed path produced with the
reference (`check`)."""
