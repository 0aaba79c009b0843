"""kernel_roofline.wide: the one-lookup scan kernel's
(csrc/spec_scan.cu) share of its roofline, from its device time in the
trace (roofline.py)."""

from portbench.roofline import kernel_share

KERNEL = "spec_scan_kernel"


def read(run):
    return kernel_share(run, KERNEL)
