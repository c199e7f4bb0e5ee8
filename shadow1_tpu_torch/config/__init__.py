"""Config front end: shadow.config.xml + GraphML -> runnable simulation
(counterpart of shadow1_tpu/config).

`shadowxml.parse` reads Shadow's XML schema; `assemble.build` lowers it
onto the port's engine.
"""

from .assemble import Assembled, build, load  # noqa: F401
from .shadowxml import ShadowConfig, parse  # noqa: F401
