"""PETSc-style options database with prefix namespacing.

Counterpart of ``spectral_tpu/utils/options.py``: ``-key value`` and
``-flag`` tokens, with solver options read under a prefix
(``Options.ksp_config("vel_")`` reads the ``-vel_ksp_*`` keys).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


class Options:
    """Parsed ``-key value`` / ``-flag`` command-line options."""

    def __init__(self, argv: Sequence[str] | dict[str, str] | None = None):
        self._db: dict[str, str] = {}
        self._used: set[str] = set()
        if isinstance(argv, dict):
            self._db = {k.lstrip("-"): str(v) for k, v in argv.items()}
        elif argv:
            i = 0
            toks = list(argv)
            while i < len(toks):
                tok = toks[i]
                if not tok.startswith("-") or _is_number(tok):
                    raise ValueError(f"expected an option, got {tok!r}")
                key = tok.lstrip("-")
                if i + 1 < len(toks) and (not toks[i + 1].startswith("-")
                                          or _is_number(toks[i + 1])):
                    self._db[key] = toks[i + 1]
                    i += 2
                else:
                    self._db[key] = ""  # bare flag
                    i += 1

    # -- primitive getters ----------------------------------------------------
    def has(self, key: str) -> bool:
        key = key.lstrip("-")
        if key in self._db:
            self._used.add(key)
            return True
        return False

    def _get(self, key: str) -> Optional[str]:
        key = key.lstrip("-")
        if key in self._db:
            self._used.add(key)
            return self._db[key]
        return None

    def get_int(self, key: str, default: int) -> int:
        v = self._get(key)
        return default if v is None else int(v)

    def get_real(self, key: str, default: float) -> float:
        v = self._get(key)
        return default if v is None else float(v)

    def get_string(self, key: str, default: str) -> str:
        v = self._get(key)
        return default if v is None else v

    def get_bool(self, key: str, default: bool = False) -> bool:
        """A bare flag is true; a value is false when it is 0, false or no."""
        v = self._get(key)
        if v is None:
            return default
        return v.lower() not in ("0", "false", "no")

    def get_int_array(self, key: str, default: Sequence[int]) -> tuple[int, ...]:
        v = self._get(key)
        if v is None:
            return tuple(default)
        return tuple(int(t) for t in v.replace(" ", "").split(",") if t)

    def get_real_array(self, key: str, default=()) -> tuple[float, ...]:
        v = self._get(key)
        if v is None:
            return tuple(default)
        return tuple(float(t) for t in v.replace(" ", "").split(",") if t)

    def unused(self) -> list[str]:
        """-options_left analog: keys never consumed."""
        return sorted(set(self._db) - self._used)

    # -- prefixed solver configs ---------------------------------------------
    def ksp_config(self, prefix: str = "", default: KSPConfig = KSPConfig()) -> KSPConfig:
        """Read -{prefix}ksp_type/_rtol/_atol/_divtol/_max_it/_gmres_restart
        (the KSPSetFromOptions analog), and -{prefix}ksp_chebyshev_eigenvalues
        emin,emax (absent: the in-solve power-iteration estimate)."""
        p = prefix
        eig = self.get_real_array(f"{p}ksp_chebyshev_eigenvalues", ())
        emin, emax = (eig[0], eig[1]) if len(eig) == 2 else (default.emin, default.emax)
        return dataclasses.replace(
            default,
            type=self.get_string(f"{p}ksp_type", default.type),
            rtol=self.get_real(f"{p}ksp_rtol", default.rtol),
            atol=self.get_real(f"{p}ksp_atol", default.atol),
            dtol=self.get_real(f"{p}ksp_divtol", default.dtol),
            max_it=self.get_int(f"{p}ksp_max_it", default.max_it),
            restart=self.get_int(f"{p}ksp_gmres_restart", default.restart),
            emin=emin, emax=emax,
        )

    def pc_type(self, prefix: str = "", default: str = "fastdiag") -> str:
        return self.get_string(f"{prefix}pc_type", default)

    def newton_config(self, default: NewtonConfig = NewtonConfig()) -> NewtonConfig:
        """Read -snes_rtol/_atol/_stol/_max_it/_monitor/_linesearch_type/
        _ksp_ew/_lag_preconditioner (SNESSetFromOptions)."""
        return dataclasses.replace(
            default,
            rtol=self.get_real("snes_rtol", default.rtol),
            atol=self.get_real("snes_atol", default.atol),
            stol=self.get_real("snes_stol", default.stol),
            max_it=self.get_int("snes_max_it", default.max_it),
            monitor=self.has("snes_monitor") or default.monitor,
            line_search=self.get_string("snes_linesearch_type", default.line_search),
            ksp_ew=self.has("snes_ksp_ew") or default.ksp_ew,
            pc_lag=self.get_int("snes_lag_preconditioner", default.pc_lag),
        )
