"""Layers whose kernels a roofline reads: ``matches(kernel name)`` says
which device operations are the layer's, ``work(config, traffic)`` lists
its work for one dispatch at the cell's shapes (``yardstick.Work``). The
module a configuration names as its ``"net"`` also gives
``flops_per_frame(config, traffic)``, the whole network's operations a
frame, which ``mfu`` reads."""
