"""``K3_roofline``: K3's (the port's f64 pivoted-QR panel kernel,
``qrcp_panel_kernel<double, ...>``) share of its roofline in the traced
window, in percent: the least time ``core.bounds.panel_bound`` gives for
each of its launches, from the shapes the wrapper recorded call by call,
over K3's summed device time."""

import re

import torch

from benchmark.core.bounds import roofline_share

_QRCP = "rusty_compression_tpu_torch.ops.kernels.qrcp.qrcp_panel_f64"
PROBES = {"k3_shapes": f"{_QRCP}.launched_shapes",
          "k3_launches": f"{_QRCP}.launch_count"}
KERNEL = re.compile(r"qrcp_panel_kernel<double,")


def read(ctx):
    return roofline_share(ctx.records, "k3_shapes", "k3_launches",
                          KERNEL.search, torch.float64)
