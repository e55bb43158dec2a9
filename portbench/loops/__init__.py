"""One module per kind of traffic. A traffic mix's ``loop`` names the
module; its ``Loop(cell, seed, device)`` builds the system under test,
warms it and makes its checked steps or requests (the set-up), and then
offers ``window(seconds)``, ``profiled()``, ``release()`` and ``checks()``."""
