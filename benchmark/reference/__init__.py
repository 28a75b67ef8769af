"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch modules that a cell's timed path runs (rays and cameras, the
`freq` NeRF and its samplers and compositing, the losses and optimisers,
the SDF renderer and its step, the vMF guiding build), imported from
here alone: it imports nothing of the
program and takes nothing the program made but the state it is told to
follow (`pipeline.py` says which). Its departures from the port are noted
in the files that have them: the march is eager, the emitter is the
model's own forward in chunks (`pipeline._ChunkedQuery`), one rank only,
and the MLPs take an fp8 operand switch, the control. The caller turns
TF32 off (`pipeline.tf32_off`)."""
