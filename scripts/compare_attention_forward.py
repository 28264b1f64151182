"""Hold the attention forward against an earlier build of its source, bit for bit.

The forward kernels of ``eovax_torch/kernels/csrc/flash_attention.cu`` write the
rows' statistics (``lse``) where the autograd path asks, and each is built
twice, with and without that write: the inference path passes a null ``lse`` and
launches the variant without it. This script builds an earlier version of that
source (the path given; its C entries may or may not take ``lse``, which the
script reads from the source and passes as null) with the package's nvcc flags,
and checks on the card that the current kernels return the same bits at each
kernel width (D = 64, 128, 256, 512 and the D-split 640 and 1024, bf16 and
fp32, odd S), with ``lse`` null and with it written, so both variants equal
each other and the earlier build. It prints one line a case and the card's name
and power limit, and exits 1 if any case differs:

    python3 scripts/compare_attention_forward.py <earlier flash_attention.cu>
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eovax_torch.kernels import attention, build  # noqa: E402

OUT_DIR = ROOT / "build" / "compare_attention_forward"
CASES = [(4, 1037, 64), (2, 777, 128), (2, 333, 256), (3, 1037, 512), (2, 129, 640),
         (1, 300, 1024)]


def takes_lse(source: Path) -> bool:
    """Whether the C entries of the source take an ``lse`` pointer."""
    return "int D, float* lse, void* stream" in source.read_text()


def earlier_library(source: Path) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lse = [ctypes.c_void_p] if takes_lse(source) else []
    so = OUT_DIR / "earlier_flash_attention.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for dtype in ("bf16", "f32"):
        fn = getattr(lib, f"eovax_flash_attention_{dtype}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + lse + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"eovax_flash_attention_split_{dtype}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + lse + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = earlier_library(Path(argv[0]))
    null_lse = (None,) if takes_lse(Path(argv[0])) else ()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    same_all = True
    for b, s, d in CASES:
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            g = torch.Generator(device=dev).manual_seed(d + s)
            q, k, v = (torch.randn(b, s, d, generator=g, device=dev).to(dtype) for _ in range(3))
            earlier = torch.empty_like(q)
            split = d > attention.KERNEL_HEAD_DIMS[-1]
            entry = getattr(lib, f"eovax_flash_attention_{'split_' if split else ''}{name}")
            extra = (d,) if split else ()
            code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), earlier.data_ptr(), b, s, d,
                         *extra, *null_lse, stream)
            if code != 0:
                raise RuntimeError(f"earlier build: CUDA error {code}")
            now = attention.flash_attention(q, k, v)
            with_lse, _ = attention.flash_attention_with_lse(q, k, v)
            torch.cuda.synchronize()
            same = torch.equal(now, earlier) and torch.equal(with_lse, earlier)
            same_all &= same
            print(f"[{b},{s},{d}] {name}: lse null {torch.equal(now, earlier)}, lse written "
                  f"{torch.equal(with_lse, earlier)} (torch.equal to the earlier build) [{card}]")
    print(f"all bit-identical: {same_all} [{card}]")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
