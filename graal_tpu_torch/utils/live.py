"""Live assembly monitoring: a self-refreshing HTML page in the output
directory.

Counterpart of ``graal_tpu.utils.live``. The reference welds a GL particle
view and a wx live plot into the sampler process (gl_update_pos
kernels3.cu:3824-3973; main_gl.py:811-954); a batch job owns no display,
so the live surface is ``<out>/live.html``, which any browser re-renders
every few seconds from two small JSON files the run rewrites each cycle:

- ``live_status.json``: the metric row (cycle, log-likelihood, n_contigs,
  distance to the reference genome, temperature, ...) and the likelihood
  series of the sparkline,
- ``live_particles.json``: per fragment (strided to at most 20,000) its
  contig, in-contig position, colour index (source chromosome when known)
  and activity, for the page's 3D particle view (the browser-side twin of
  ``gl_update_pos``: each particle springs toward its contig / position
  target with jitter, so coalescing chromosomes are visible live),

and the current genome-layout painting (``utils.plots.plot_genome_layout``,
written only where matplotlib is installed). The page and both files are
byte for byte the JAX package's for the same state and stats.
"""

from __future__ import annotations

import json
import os

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>graal_tpu live</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 24px; color: #222; }}
 .row {{ display: flex; gap: 24px; flex-wrap: wrap; align-items: center; }}
 .stat {{ background: #f4f4f4; border-radius: 8px; padding: 10px 16px; }}
 .stat b {{ display: block; font-size: 22px; }}
 img {{ max-width: 100%; border: 1px solid #ddd; border-radius: 6px; }}
 svg polyline {{ fill: none; stroke: #2563eb; stroke-width: 2; }}
 canvas {{ border: 1px solid #ddd; border-radius: 6px; background: #0b1020; }}
</style></head>
<body>
<h2>graal_tpu — live assembly</h2>
<div class="row" id="stats"></div>
<div class="row">
  <canvas id="gl" width="640" height="480"></canvas>
  <div id="spark"></div>
</div>
<p><img id="layout" src="{painting}" alt="genome layout"></p>
<script>
// ---- 3D particle view (gl_update_pos redesign: physics in the client) --
let P = null;            // particle state: x,y,z + targets + colour
let contigLayout = {{}}; // id_c -> [cx, cz, ux, uz] rod origin + direction
function layoutContigs(idc, pos) {{
  // golden-angle spiral of contig rods, longest contigs innermost
  const count = {{}};
  for (const c of idc) count[c] = (count[c] || 0) + 1;
  const ids = Object.keys(count).sort((a, b) => count[b] - count[a]);
  const L = {{}};
  const GA = Math.PI * (3 - Math.sqrt(5));
  ids.forEach((c, k) => {{
    const r = 14 * Math.sqrt(k + 1);
    const th = k * GA;
    L[c] = [r * Math.cos(th), r * Math.sin(th),
            Math.cos(th + Math.PI / 2), Math.sin(th + Math.PI / 2)];
  }});
  return L;
}}
function setTargets(d) {{
  const n = d.id_c.length;
  contigLayout = layoutContigs(d.id_c, d.pos);
  if (!P || P.n !== n) {{
    P = {{n: n, x: new Float32Array(n), y: new Float32Array(n),
         z: new Float32Array(n), tx: new Float32Array(n),
         ty: new Float32Array(n), tz: new Float32Array(n),
         col: d.chrom.map(h => `hsl(${{(h * 47) % 360}},85%,62%)`)}};
    for (let i = 0; i < n; i++) {{
      P.x[i] = (Math.random() - .5) * 300;
      P.y[i] = (Math.random() - .5) * 300;
      P.z[i] = (Math.random() - .5) * 300;
    }}
  }}
  for (let i = 0; i < n; i++) {{
    const l = contigLayout[d.id_c[i]];
    P.tx[i] = l[0] + l[2] * d.pos[i] * 1.2;
    P.tz[i] = l[1] + l[3] * d.pos[i] * 1.2;
    P.ty[i] = (d.active && !d.active[i]) ? -120 : 0;  // parked when inactive
  }}
}}
let ang = 0;
function frame() {{
  const cv = document.getElementById('gl'), g = cv.getContext('2d');
  g.fillStyle = '#0b1020'; g.fillRect(0, 0, cv.width, cv.height);
  if (P) {{
    ang += 0.004;
    const ca = Math.cos(ang), sa = Math.sin(ang);
    const f = 420, camz = 260;
    for (let i = 0; i < P.n; i++) {{
      // gl_update_pos physics: spring toward target + jitter
      P.x[i] += (P.tx[i] - P.x[i]) * 0.06 + (Math.random() - .5) * .8;
      P.y[i] += (P.ty[i] - P.y[i]) * 0.06 + (Math.random() - .5) * .8;
      P.z[i] += (P.tz[i] - P.z[i]) * 0.06 + (Math.random() - .5) * .8;
      const rx = P.x[i] * ca + P.z[i] * sa;
      const rz = -P.x[i] * sa + P.z[i] * ca + camz;
      if (rz <= 20) continue;
      const sx = cv.width / 2 + rx / rz * f;
      const sy = cv.height / 2 + (P.y[i] - 30) / rz * f;
      g.fillStyle = P.col[i];
      const s = Math.max(1, 240 / rz);
      g.fillRect(sx, sy, s, s);
    }}
  }}
  requestAnimationFrame(frame);
}}
frame();
async function tick() {{
  try {{
    const r = await fetch('live_status.json', {{cache: 'no-store'}});
    const s = await r.json();
    const rows = [];
    for (const [k, v] of Object.entries(s.stats))
      rows.push(`<div class="stat">${{k}}<b>${{v}}</b></div>`);
    document.getElementById('stats').innerHTML = rows.join('');
    const ll = s.likelihood || [];
    if (ll.length > 1) {{
      const w = 420, h = 120;
      const mn = Math.min(...ll), mx = Math.max(...ll);
      const pts = ll.map((v, i) =>
        `${{(i / (ll.length - 1) * w).toFixed(1)}},` +
        `${{(h - (v - mn) / (mx - mn + 1e-9) * h).toFixed(1)}}`).join(' ');
      document.getElementById('spark').innerHTML =
        `<svg width="${{w}}" height="${{h}}"><polyline points="${{pts}}"/></svg>`;
    }}
    try {{
      const pr = await fetch('live_particles.json', {{cache: 'no-store'}});
      if (pr.ok) setTargets(await pr.json());
    }} catch (e) {{}}
    const img = document.getElementById('layout');
    img.src = '{painting}?t=' + Date.now();
  }} catch (e) {{}}
  setTimeout(tick, 3000);
}}
tick();
</script>
</body></html>
"""


def _atomic_write(path: str, text: str):
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def _host(x):
    """A state field (torch tensor on any device, or array) as numpy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def particle_payload(state, chrom_of_bin=None, max_particles=20_000):
    """Compact per-fragment arrays for the 3D particle view: contig id,
    in-contig position, colour index (source chromosome when known) and
    activity. Strided down to ``max_particles`` for browser-sized
    payloads at chr1 scale (the reference's GL view has the same role
    but draws on the sampler's own GPU, gl_update_pos
    kernels3.cu:3824-3973)."""
    idc = _host(state.id_c)
    pos = _host(state.pos)
    act = _host(state.activ)
    n = len(idc)
    stride = max(1, -(-n // max_particles))
    sel = np.arange(0, n, stride)
    if chrom_of_bin is None:
        chrom = idc
    else:
        chrom = np.asarray(chrom_of_bin)
        if len(chrom) != n:       # repeat-expanded genome: map via id_d
            chrom = chrom[_host(state.id_d)]
    out = {
        "id_c": idc[sel].astype(int).tolist(),
        "pos": pos[sel].astype(int).tolist(),
        "chrom": chrom[sel].astype(int).tolist(),
    }
    if not bool(np.all(act == 1)):
        out["active"] = act[sel].astype(int).tolist()
    return out


def update(out_dir: str, stats: dict, likelihood_series,
           painting: str = "layout_latest.png", state=None,
           chrom_of_bin=None):
    """Refresh the live surface: ``stats`` is the metric row (cycle,
    loglik, ...), ``likelihood_series`` feeds the sparkline, ``painting``
    is the relative path of the layout image the page shows (the caller
    re-renders it). Passing the genome ``state`` also refreshes the 3D
    particle view. Creates ``live.html`` on first call."""
    os.makedirs(out_dir, exist_ok=True)
    page = os.path.join(out_dir, "live.html")
    if not os.path.exists(page):
        _atomic_write(page, _PAGE.format(painting=painting))
    _atomic_write(
        os.path.join(out_dir, "live_status.json"),
        json.dumps({"stats": {k: (round(v, 3) if isinstance(v, float) else v)
                              for k, v in stats.items()},
                    "likelihood": [float(x) for x in likelihood_series]}))
    if state is not None:
        _atomic_write(os.path.join(out_dir, "live_particles.json"),
                      json.dumps(particle_payload(state, chrom_of_bin)))


def refresh(out_dir: str, cycle: int, state, chrom_of_bin, stats: dict, series,
            snapshot_every: int = 0, watch: bool = False):
    """A run's pictures after cycle ``cycle`` (0-based), on the writing
    rank only: the layout painting ``layout_<cycle + 1>.png`` every
    ``snapshot_every`` cycles and, with ``watch``, ``layout_latest.png``
    and :func:`update` with ``stats`` and ``series``. The paintings need
    ``chrom_of_bin`` (and matplotlib, without which they are skipped)."""
    from graal_tpu_torch.parallel.sharding import is_writer
    from graal_tpu_torch.utils.plots import plot_genome_layout

    if not is_writer():
        return
    if snapshot_every and (cycle + 1) % snapshot_every == 0 and chrom_of_bin is not None:
        plot_genome_layout(state, chrom_of_bin, out_dir, out_name=f"layout_{cycle + 1:04d}.png")
    if watch:
        if chrom_of_bin is not None:
            plot_genome_layout(state, chrom_of_bin, out_dir, out_name="layout_latest.png")
        update(out_dir, stats, series, state=state, chrom_of_bin=chrom_of_bin)
