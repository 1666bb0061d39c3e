"""One module per kind of traffic (a traffic file's ``kind``). Each has
``setup(cfg, traffic, seed, device, fault=None)`` returning the cell's
timed path, and ``control(cfg, traffic, seed, device)`` returning the
numbers of the reference in fp8 put in the program's place."""
