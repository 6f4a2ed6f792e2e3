"""Colour tables of the port's map renders, without matplotlib (the card's
machine has none): every map of the JAX package's `CMAPS`
(srewd_tpu/training/visualization.py), and `apply`, which colours a field
as matplotlib's `cmap(Normalize(vmin, vmax)(field), bytes=True)` does,
byte for byte.

A map is its lookup table of N colours plus the under, over and bad entries
(matplotlib's `_lut`, N + 3 rows), already in bytes: matplotlib's bytes mode
takes `(lut * 255).astype(uint8)`, so the bytes are all that colouring needs.

- heat_vibrant and heat_muted (N=100), ae_color and abs_color (N=256):
  built here from the reference's colour lists by the rule of
  `LinearSegmentedColormap.from_list` and `_create_lookup_table`, written
  out in numpy (`from_list` below).
- residual_mask: a listed map of white, gray and black with the under
  colour 0.75 gray and the over colour 0.25 gray.
- coolwarm, plasma, viridis and gray: matplotlib's 256-colour tables,
  generated once from matplotlib 3.10 and kept below as RGB bytes in hex
  (their under and over entries are the first and last colours; bad is
  transparent black).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# matplotlib's CSS4 colours of the names the reference's lists use
_NAMED = {"darkblue": "00008b", "blue": "0000ff", "cyan": "00ffff", "green": "008000",
          "yellow": "ffff00", "red": "ff0000", "lightblue": "add8e6", "white": "ffffff",
          "salmon": "fa8072", "darkred": "8b0000", "gray": "808080", "black": "000000"}


def to_rgba(color) -> tuple:
    """matplotlib's to_rgba for the forms used here: an RGB tuple, a name
    of _NAMED, or a gray level as a string ("0.25")."""
    if isinstance(color, str):
        if color in _NAMED:
            h = _NAMED[color]
            return tuple(int(h[i:i + 2], 16) / 255 for i in (0, 2, 4)) + (1.0,)
        v = float(color)
        return (v, v, v, 1.0)
    return tuple(float(c) for c in color) + ((1.0,) if len(color) == 3 else ())


@dataclass(frozen=True)
class Colormap:
    """A lookup table in bytes: rows 0..N-1 the colours, then under (N),
    over (N+1) and bad (N+2)."""
    name: str
    lut: np.ndarray  # uint8 [N + 3, 4]

    @property
    def N(self) -> int:
        return self.lut.shape[0] - 3


def _with_extremes(name: str, colors: np.ndarray, under=None, over=None,
                   bad=(0.0, 0.0, 0.0, 0.0)) -> Colormap:
    """matplotlib's `_set_extremes` on a float table of N colours, in bytes."""
    lut = np.concatenate([colors, np.zeros((3, 4))])
    n = len(colors)
    lut[n] = to_rgba(under) if under is not None else lut[0]
    lut[n + 1] = to_rgba(over) if over is not None else lut[n - 1]
    lut[n + 2] = bad
    return Colormap(name, (lut * 255).astype(np.uint8))


def _lookup_table(n: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """matplotlib's `_create_lookup_table` for continuous data (y0 == y1),
    gamma 1."""
    x = x * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1], [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


def from_list(name: str, colors, n: int = 256) -> Colormap:
    """`LinearSegmentedColormap.from_list(name, colors, N=n)`: colours spaced
    evenly over [0, 1], or (position, colour) pairs."""
    if isinstance(colors[0], tuple) and len(colors[0]) == 2:
        vals, colors = zip(*colors)
    else:
        vals = np.linspace(0, 1, len(colors))
    rgba = np.array([to_rgba(c) for c in colors], float)
    x = np.asarray(vals, float)
    table = np.stack([_lookup_table(n, x, rgba[:, c]) for c in range(4)], axis=1)
    return _with_extremes(name, table)


def listed(name: str, colors, under=None, over=None) -> Colormap:
    """`ListedColormap(colors).with_extremes(under=, over=)`."""
    return _with_extremes(name, np.array([to_rgba(c) for c in colors], float), under, over)


def _heat_vibrant() -> Colormap:
    # the reference's colour list: purple, blue, cyan, green, yellow, orange, red
    return from_list("custom_heatmap_vibrant", [
        (0.5, 0, 0.5), (0, 0, 1), (0, 1, 1), (0, 1, 0), (1, 1, 0), (1, 0.5, 0), (1, 0, 0)], 100)


def _heat_muted() -> Colormap:
    return from_list("heat_muted", [
        (0.75, 0.5, 0.75), (0.5, 0.5, 1), (0.5, 1, 1), (0.5, 1, 0.5), (1, 1, 0.5),
        (1, 0.75, 0.5), (1, 0.5, 0.5)], 100)


def _ae_color() -> Colormap:
    return from_list("custom_ae", [(0.0, "darkblue"), (0.08, "blue"), (0.16, "cyan"),
                                   (0.3, "green"), (0.5, "yellow"), (1.0, "red")])


def _abs_color() -> Colormap:
    # diverging, anchored at -25 / -5 / 0 / 5 / 25 of the fixed [-25, 25] range
    lo, hi = -25.0, 25.0
    zero, light_blue, light_red = ((v - lo) / (hi - lo) for v in (0.0, -5.0, 5.0))
    return from_list("CustomMap", [(0.0, "darkblue"), (light_blue, "lightblue"),
                                   (zero, "white"), (light_red, "salmon"), (1.0, "darkred")])


# matplotlib 3.10's tables, RGB bytes in hex, 256 colours each
_TABLES = {
    "coolwarm": (
        "3a4cc03b4dc13c4fc33e51c43f53c64054c74156c94258ca435acc455bcd465dcf475fd04860d14962d34b64"
        "d44c66d64d67d74e69d8506bda516cdb526edc5370dd5571de5673e05775e15876e25a78e35b79e45c7be55d"
        "7de65f7ee76080e86182ea6383ea6485eb6586ec6788ed6889ee698bef6b8df06c8ef16d90f16f91f27093f3"
        "7194f47395f47497f57598f6779af6789bf77a9df87b9ef87ca0f97ea1f97fa2fa80a4fa82a5fb83a6fb85a8"
        "fb86a9fc87aafc89acfc8aadfd8baefd8daffd8eb1fd90b2fe91b3fe92b4fe94b5fe95b7fe97b8fe98b9fe99"
        "bafe9bbbfe9cbcfe9dbdfe9fbefea0bffea2c0fea3c1fea4c2fea6c3fda7c4fda8c5fdaac6fdabc7fcacc8fc"
        "aec9fcafcafbb0cbfbb2cbfbb3ccfab4cdfab6cef9b7cff9b8cff8b9d0f8bbd1f7bcd1f6bdd2f6bed3f5c0d3"
        "f5c1d4f4c2d4f3c3d5f2c5d5f2c6d6f1c7d6f0c8d7efc9d7eecad8eeccd8edcdd9ecced9ebcfd9ead0dae9d1"
        "dae8d2dae7d3dbe6d5dbe5d6dbe4d7dbe2d8dbe1d9dce0dadcdfdbdcdedcdcdddddcdbdedbdadfdbd9e0dad7"
        "e1dad6e2d9d4e3d9d3e4d8d1e5d8d0e6d7cfe7d6cde7d6cce8d5cae9d4c9ead3c7ebd3c6ecd2c4ecd1c3edd0"
        "c1edcfc0eecfbeefcebcefcdbbf0ccb9f1cbb8f1cab6f2c9b5f2c8b3f2c7b2f3c6b0f3c5aff4c4adf4c3abf4"
        "c2aaf5c1a8f5c0a7f5bfa5f6bda4f6bca2f6bba0f6ba9ff6b99df6b79cf6b69af7b598f7b397f7b295f7b194"
        "f7b092f7ae91f7ad8ff6ab8df6aa8cf6a98af6a789f6a687f6a486f6a384f5a182f5a081f59e7ff49d7ef49b"
        "7cf49a7bf39879f39678f39576f29375f29173f19072f18e70f08d6ff08b6def896cee876aee8669ed8467ec"
        "8266ec8064eb7f63ea7d61ea7b60e9795ee8775de7755ce6745ae67259e57057e46e56e36c54e26a53e16852"
        "e06650df644fde624edd604cdc5e4bdb5c4ada5a48d95847d85646d75444d65243d44f42d34d40d24b3fd149"
        "3ecf463dce443ccd423acc3f39ca3d38c93b37c83835c63534c53233c43032c22d31c12a30bf282ebe232dbc"
        "1f2cbb1a2bb9162ab81129b60d28b50827b30326"
    ),
    "plasma": (
        "0c078610078713068915068a18068b1b068c1d068d1f058e21058f2305902505912705922905932b05942d04"
        "942f04953104963304973404983604983804993a049a3b039a3d039b3f039c40039c42039d44039e45039e47"
        "029f49029f4a02a04c02a14e02a14f02a25101a25201a35401a35601a35701a45901a45a00a55c00a55e00a5"
        "5f00a66100a66200a66400a76500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500"
        "a87601a87801a87901a87b02a87c02a77e03a77f03a78104a78204a78405a68506a68607a68807a58908a58b"
        "09a48c0aa48e0ca48f0da3900ea3920fa29310a19511a19612a09713a099149f9a159e9b179e9d189d9e199c"
        "9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296a92395aa2494ac2593ad2692ae2791af2890b02a"
        "8fb12b8fb22c8eb42d8db52e8cb62f8bb7308ab83289b93388ba3487bb3586bc3685bd3784be3883bf3982c0"
        "3b81c13c80c23d80c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678cb4777cc4876cd4975ce4a75"
        "cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586ad95969da5a68db5b"
        "67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660e3675fe3685ee46a5de56b5ce56c5be6"
        "6d5ae76e5ae87059e87158e97257ea7356ea7455eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4e"
        "f0804df0814df1824cf2844bf2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f792"
        "41f79341f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436fca635fc"
        "a735fca934fcaa33fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62dfdb82cfdb92bfdbb2bfdbc2a"
        "fdbe29fdc029fdc128fdc328fdc427fdc626fcc726fcc926fccb25fccc25fcce25fbd024fbd124fbd324fad5"
        "24fad624fad824f9d924f9db24f8dd24f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3"
        "ee26f2f026f2f126f1f326f0f525f0f623eff821"
    ),
    "viridis": (
        "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f624711634712654714664715"
        "6747166947186a48196b481a6c481c6e481d6f481e7048207148217248227348237447257547267647277747"
        "2878472a79472b7a472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83"
        "433b83433c84423d84423e854240854141864142864043874044873f45873f47883e48883e49893d4a893d4b"
        "893d4c893c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c36"
        "5b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d31668d30678d30688d2f698d"
        "2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e2c728e2b738e2b748e2a758e2a768e2a778e2978"
        "8e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24"
        "868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
        "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e881e9f881ea0871fa1"
        "871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad8028ae7f29"
        "af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
        "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7"
        "645bc8625ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517c"
        "d24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938"
        "a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e0"
        "1fcae01ecde01dcfe11cd2e11bd4e11ad7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aee"
        "e51bf1e51cf3e51ef6e61ff8e621fae622fde724"
    ),
    "gray": (
        "0000000101010202020303030404040505050606060707070808080909090a0a0a0b0b0b0c0c0c0d0d0d0e0e"
        "0e0f0f0f1010101111111212121313131414141515151616161717171818181919191a1a1a1b1b1b1c1c1c1d"
        "1d1d1e1e1e1f1f1f2020202020202222222323232424242424242626262727272828282828282a2a2a2b2b2b"
        "2c2c2c2c2c2c2e2e2e2f2f2f3030303030303232323333333434343434343636363737373838383838383a3a"
        "3a3b3b3b3c3c3c3c3c3c3e3e3e3f3f3f40404041414141414143434344444445454546464647474748484849"
        "49494949494b4b4b4c4c4c4d4d4d4e4e4e4f4f4f505050515151515151535353545454555555565656575757"
        "5858585959595959595b5b5b5c5c5c5d5d5d5e5e5e5f5f5f6060606161616161616363636464646565656666"
        "666767676868686969696969696b6b6b6c6c6c6d6d6d6e6e6e6f6f6f70707071717171717173737374747475"
        "75757676767777777878787979797979797b7b7b7c7c7c7d7d7d7e7e7e7f7f7f808080818181828282838383"
        "8383838585858686868787878888888989898a8a8a8b8b8b8c8c8c8d8d8d8e8e8e8f8f8f9090909191919292"
        "929393939393939595959696969797979898989999999a9a9a9b9b9b9c9c9c9d9d9d9e9e9e9f9f9fa0a0a0a1"
        "a1a1a2a2a2a3a3a3a3a3a3a5a5a5a6a6a6a7a7a7a8a8a8a9a9a9aaaaaaabababacacacadadadaeaeaeafafaf"
        "b0b0b0b1b1b1b2b2b2b3b3b3b3b3b3b5b5b5b6b6b6b7b7b7b8b8b8b9b9b9babababbbbbbbcbcbcbdbdbdbebe"
        "bebfbfbfc0c0c0c1c1c1c2c2c2c3c3c3c3c3c3c5c5c5c6c6c6c7c7c7c8c8c8c9c9c9cacacacbcbcbcccccccd"
        "cdcdcecececfcfcfd0d0d0d1d1d1d2d2d2d3d3d3d3d3d3d5d5d5d6d6d6d7d7d7d8d8d8d9d9d9dadadadbdbdb"
        "dcdcdcdddddddedededfdfdfe0e0e0e1e1e1e2e2e2e3e3e3e3e3e3e5e5e5e6e6e6e7e7e7e8e8e8e9e9e9eaea"
        "eaebebebecececedededeeeeeeefefeff0f0f0f1f1f1f2f2f2f3f3f3f3f3f3f5f5f5f6f6f6f7f7f7f8f8f8f9"
        "f9f9fafafafbfbfbfcfcfcfdfdfdfefefeffffff"
    ),
}


def _table(name: str) -> Colormap:
    rgb = np.frombuffer(bytes.fromhex("".join(_TABLES[name])), np.uint8).reshape(256, 3)
    lut = np.concatenate([np.concatenate([rgb, np.full((256, 1), 255, np.uint8)], axis=1),
                          np.zeros((3, 4), np.uint8)])
    lut[256], lut[257] = lut[0], lut[255]
    return Colormap(name, lut)


_HV, _HM, _AE, _ABS = _heat_vibrant(), _heat_muted(), _ae_color(), _abs_color()
_RM = listed("residual_mask", ["white", "gray", "black"], under="0.75", over="0.25")
CMAPS = {
    "heat_vibrant": _HV,
    "custom_heatmap_vibrant": _HV,  # the reference's name
    "heat_muted": _HM,
    "ae_color": _AE,
    "custom_ae": _AE,
    "abs_color": _ABS,
    "custom": _ABS,
    "residual_mask": _RM,
    "binary": _RM,
    **{name: _table(name) for name in _TABLES},
}


def normalize(field, vmin: float, vmax: float) -> np.ndarray:
    """matplotlib's `Normalize(vmin, vmax)(field)` (clip off): a float field
    keeps its dtype, and (field - vmin) / (vmax - vmin) runs in place, with
    vmin and vmax as float64 scalars, as matplotlib computes it."""
    dtype = np.min_scalar_type(field)
    if np.issubdtype(dtype, np.integer) or dtype.type is np.bool_:
        dtype = np.promote_types(dtype, np.float32)
    x = np.array(field, dtype=dtype, copy=True)
    lo, hi = np.float64(vmin), np.float64(vmax)
    if lo == hi:
        x.fill(0)
    elif lo > hi:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    else:
        x -= lo
        x /= (hi - lo)
    return x


def apply(cmap: Colormap, field, vmin: float, vmax: float) -> np.ndarray:
    """uint8 RGBA [..., 4] of `field` coloured by `cmap` over [vmin, vmax]:
    matplotlib's `cmap(Normalize(vmin, vmax)(field), bytes=True)`, with its
    rules: x == 1 takes colour N-1, x < 0 the under entry, x > 1 the over
    entry, NaN the bad entry."""
    n = cmap.N
    xa = normalize(field, vmin, vmax)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over], idx[bad] = n, n + 1, n + 2
    return cmap.lut.take(idx, axis=0, mode="clip")
