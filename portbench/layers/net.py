"""The net: the four planar kernels (csrc/planar_conv.cu, planar_conv2.cu,
planar_gru.cu). Per dispatch the stateless half runs once over its frames
and the recurrent half once a time step over its streams."""

from portbench.yardstick import (decoder_work, encoder_work, geometry,
                                 net_shape)


def matches(name: str) -> bool:
    return "planar_" in name


def work(config: dict, traffic: dict):
    geo = geometry(config, traffic)
    net = net_shape(config, traffic)
    return (encoder_work(net, geo.frames)
            + decoder_work(net, geo.streams) * geo.steps)
