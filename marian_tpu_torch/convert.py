"""Parameters from numpy to the port's tensors.

The input is the JAX package's flat, Marian-named parameter dict as
numpy: ``EncoderDecoder.init()`` passed through ``np.asarray``, or an
``.npz`` written by either package (``common.io.load_model``).

Weight layout: Marian stores every projection ``W`` as [in, out] and
applies it as ``x @ W``; the port keeps that layout (no transposes), so
names and shapes match the reference one for one. Biases and layer-norm
parameters stay [1, dim]. Tied embeddings are one ``Wemb`` tensor that
the source embedding, the target embedding and the output layer all
read (the output layer through a transposed view), so it is shared, not
copied.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch


def params_from_numpy(flat: Mapping[str, np.ndarray],
                      device: Union[str, torch.device],
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """Flat numpy dict → tensors on ``device``; floating arrays are cast
    to ``dtype`` (the compute dtype), integer arrays keep theirs."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":       # ml_dtypes arrays from JAX
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, copy=True))   # owned, writable
        if t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(device)
    return out
