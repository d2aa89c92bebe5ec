"""The strip compositor's VJP against float64, in the port and in the JAX
package, where lists are full: the flagship's 100,000 Gaussians at 256^2
(64 strips, capacity 1024, 134,159 entries dropped).

The gradient of a weighted sum of the image to the coefficient table
(`probe_torch_reference.table_grads`: the port's plain K3,
`composite_strips_bwd_plain`, in float32 and in float64 on the same table
and lists; the reference's Pallas VJP in interpret mode) summed per
Gaussian. Measured: the port within 8.0e-6
relative L2 of float64 on every lane; the reference within 7.8e-6 on the
linear lanes but 2.6e-5 / 2.7e-5 / 3.7e-5 on the x^2, y^2 and constant
lanes, whose strip-local moments cancel when shifted to the home strip.
On a Gaussian whose gradient is small against its lists' other entries
that error is its whole gradient: at the flagship frame (512^2) it is
what holds the LPIPS-on step's rotation gradient at 7.9e-4 relative L2
from the reference, on the CPU and on the card alike (`PERF.md` §6).
"""
import pytest

from dimo_tpu_torch import reference_check as rc
from probe_torch_reference import lane_rel, port_stages, table_grads

from torch_parity import one_torch_thread  # noqa: F401

SPEC = rc.Spec(width=256, height=256)
QUADRATIC = (0, 2, 5)           # the x^2, y^2 and constant lanes


@pytest.fixture(scope="module")
def grads():
    """`probe_torch_reference.table_grads` at 256^2 (port float32, port
    float64, the reference) and the lists' overflow."""
    _, p, aux, cam = rc.port_scene(SPEC, "cpu")
    st = port_stages(p, aux, cam, SPEC)
    return (*table_grads(st["table"], st["lists"], SPEC.width),
            int(st["lists"].overflow))


@pytest.mark.parametrize("lane", range(6))
def test_port_strip_vjp_is_float64_close(grads, lane):
    p32, p64, _, overflow = grads
    assert overflow > 0                       # the lists are full
    assert lane_rel(p32, p64, lane) <= 1e-5


@pytest.mark.parametrize("lane", QUADRATIC)
def test_reference_strip_vjp_rounds_its_quadratic_lanes(grads, lane):
    """The measured delta, pinned: the reference 3-10x farther from
    float64 than the port on these lanes, and within 1e-4."""
    p32, p64, ref, _ = grads
    assert 3 * lane_rel(p32, p64, lane) <= lane_rel(ref, p64, lane) <= 1e-4
