"""The port's copy of BayesPR's region construction against the JAX
package's `nextgp_tpu.data.regions`: the no-map sentinels 1 and 9999, a map
with r = 99 (one region per chromosome), r = 9999 and windows, on
genome-ordered and interleaved chromosome maps; and the errors."""
import numpy as np
import pytest

from nextgp_tpu.data import regions as jreg
from nextgp_tpu_torch.data import regions as treg

P = 50
MAPS = {
    "ordered": np.repeat([1, 2, 3], [20, 17, 13]),
    "interleaved": (np.arange(P) // 7) % 3 + 1,
    "strings": np.array(["chr2"] * 10 + ["chr1"] * 25 + ["chr2"] * 15),
}


def _same(a, b):
    assert a.n_regions == b.n_regions
    assert a.region_id.dtype == b.region_id.dtype == np.int32
    np.testing.assert_array_equal(a.region_id, b.region_id)
    np.testing.assert_array_equal(a.sizes, b.sizes)


@pytest.mark.parametrize("r", [1, 9999])
def test_sentinels_without_map(r):
    _same(treg.build_regions(P, r), jreg.build_regions(P, r))


@pytest.mark.parametrize("r", [99, 9999, 1, 6, 20])
@pytest.mark.parametrize("name", list(MAPS))
def test_map_regions(name, r):
    _same(treg.build_regions(P, r, MAPS[name]), jreg.build_regions(P, r, MAPS[name]))


def test_errors_match():
    for mod in (treg, jreg):
        with pytest.raises(ValueError, match="1 or 9999"):
            mod.build_regions(P, 20)
        with pytest.raises(ValueError, match="map length"):
            mod.build_regions(P, 20, MAPS["ordered"][:-1])
