"""Embedded single-page dashboard UI (no build step, no external assets)."""

INDEX_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: -apple-system, system-ui, sans-serif; margin: 0;
         background: #f6f7f9; color: #1a1d21; }
  @media (prefers-color-scheme: dark) {
    body { background: #16181c; color: #e8eaed; }
    .card, table { background: #1f2329 !important; }
    th { background: #272c33 !important; }
  }
  header { padding: 14px 24px; background: #2f3b52; color: #fff; }
  header h1 { margin: 0; font-size: 18px; font-weight: 600; }
  main { padding: 16px 24px; max-width: 1200px; margin: 0 auto; }
  .cards { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 18px; }
  .card { background: #fff; border-radius: 8px; padding: 12px 18px;
          box-shadow: 0 1px 3px rgba(0,0,0,.12); min-width: 130px; }
  .card .v { font-size: 22px; font-weight: 700; }
  .card .k { font-size: 12px; opacity: .7; }
  h2 { font-size: 14px; text-transform: uppercase; letter-spacing: .05em;
       opacity: .75; margin: 18px 0 6px; }
  table { width: 100%; border-collapse: collapse; background: #fff;
          border-radius: 8px; overflow: hidden; font-size: 13px;
          box-shadow: 0 1px 3px rgba(0,0,0,.12); }
  th, td { text-align: left; padding: 6px 10px;
           border-bottom: 1px solid rgba(127,127,127,.15); }
  th { background: #eef0f3; font-weight: 600; }
  .ok { color: #188038; } .bad { color: #d93025; }
</style>
</head>
<body>
<header><h1>ray_tpu_torch dashboard</h1></header>
<main>
  <div class="cards" id="cards"></div>
  <h2>Nodes</h2><table id="nodes"></table>
  <h2>Actors</h2><table id="actors"></table>
  <h2>Task summary</h2><table id="tasks"></table>
  <h2>Jobs</h2><table id="jobs"></table>
</main>
<script>
const fmt = (x) => typeof x === 'number' && !Number.isInteger(x)
    ? x.toFixed(2) : x;
function fill(id, rows, cols) {
  const t = document.getElementById(id);
  if (!rows || !rows.length) { t.innerHTML = '<tr><td>none</td></tr>'; return; }
  let h = '<tr>' + cols.map(c => '<th>' + c + '</th>').join('') + '</tr>';
  for (const r of rows.slice(0, 50)) {
    h += '<tr>' + cols.map(c => '<td>' + fmt(r[c] ?? '') + '</td>').join('')
       + '</tr>';
  }
  t.innerHTML = h;
}
async function refresh() {
  try {
    const c = await (await fetch('api/cluster')).json();
    document.getElementById('cards').innerHTML = [
      ['nodes', c.num_nodes], ['CPUs', c.resources.CPU || 0],
      ['GPUs', c.resources.GPU || 0],
      ['actors', c.num_actors], ['running tasks', c.running_tasks],
    ].map(([k, v]) => '<div class="card"><div class="v">' + fmt(v ?? 0)
        + '</div><div class="k">' + k + '</div></div>').join('');
    const nodes = await (await fetch('api/nodes')).json();
    fill('nodes', nodes.map(n => ({
      id: (n.node_id || '').slice(0, 12), host: n.hostname,
      alive: n.alive, cpu: (n.total || {}).CPU,
      gpu: (n.total || {}).GPU || 0,
    })), ['id', 'host', 'alive', 'cpu', 'gpu']);
    const actors = await (await fetch('api/actors')).json();
    fill('actors', actors.map(a => ({
      id: (a.actor_id || '').slice(0, 12), name: a.name || '',
      state: a.state, restarts: a.restarts,
    })), ['id', 'name', 'state', 'restarts']);
    const ts = await (await fetch('api/task_summary')).json();
    fill('tasks', Object.entries(ts).map(([name, st]) => ({
      name, ...st })), ['name', 'pending', 'running', 'done', 'failed']);
    const jobs = await (await fetch('api/jobs')).json();
    fill('jobs', jobs.map(j => ({
      id: j.job_id, status: j.status, entrypoint: j.entrypoint })),
      ['id', 'status', 'entrypoint']);
  } catch (e) { console.error(e); }
}
refresh(); setInterval(refresh, 2000);
</script>
</body>
</html>
"""
