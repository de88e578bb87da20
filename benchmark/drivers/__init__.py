"""The general generators: one per kind of loop. A traffic file names its
driver (`"driver"`) and gives its parameters; a driver's `Cell(cfg, traffic,
seed, device, workdir)` has setup(), window(seconds), traced(n), release() and
check(limits)."""
