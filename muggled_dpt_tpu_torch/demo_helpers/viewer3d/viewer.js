/* DPT 3D depth viewer.
 *
 * Fetches frames from the run_3dviewer.py server (rgb jpg + 24-bit-packed
 * depth png concatenated; X-rgb-size / X-depth-size headers), decodes the
 * depth to floats, and renders a dense plane mesh whose vertices are
 * displaced along z by (A * depth + B). Blender-style orbit camera and
 * client-side OBJ / GLB mesh export.
 */

"use strict";

// ---------------------------------------------------------------------------
// Small column-major mat4 helpers
function matIdentity() { const m = new Float32Array(16); m[0] = m[5] = m[10] = m[15] = 1; return m; }
function matMultiply(a, b) {
  const out = new Float32Array(16);
  for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++) {
    let s = 0;
    for (let k = 0; k < 4; k++) s += a[k * 4 + r] * b[c * 4 + k];
    out[c * 4 + r] = s;
  }
  return out;
}
function matPerspective(fovYRad, aspect, near, far) {
  const f = 1 / Math.tan(fovYRad / 2);
  const m = new Float32Array(16);
  m[0] = f / aspect; m[5] = f;
  m[10] = (far + near) / (near - far); m[11] = -1;
  m[14] = (2 * far * near) / (near - far);
  return m;
}
function matLookAtOrbit(dist, yaw, pitch, target) {
  // camera orbiting `target` at spherical (dist, yaw, pitch)
  const cx = target[0] + dist * Math.cos(pitch) * Math.sin(yaw);
  const cy = target[1] + dist * Math.sin(pitch);
  const cz = target[2] + dist * Math.cos(pitch) * Math.cos(yaw);
  const eye = [cx, cy, cz];
  const f = normalize3(sub3(target, eye));
  const s = normalize3(cross3(f, [0, 1, 0]));
  const u = cross3(s, f);
  const m = matIdentity();
  m[0] = s[0]; m[4] = s[1]; m[8] = s[2];
  m[1] = u[0]; m[5] = u[1]; m[9] = u[2];
  m[2] = -f[0]; m[6] = -f[1]; m[10] = -f[2];
  m[12] = -dot3(s, eye); m[13] = -dot3(u, eye); m[14] = dot3(f, eye);
  return m;
}
const sub3 = (a, b) => [a[0] - b[0], a[1] - b[1], a[2] - b[2]];
const dot3 = (a, b) => a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
const cross3 = (a, b) => [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]];
function normalize3(v) { const l = Math.hypot(v[0], v[1], v[2]) || 1; return [v[0] / l, v[1] / l, v[2] / l]; }

// ---------------------------------------------------------------------------
// WebGL setup
const canvas = document.getElementById("gl");
const gl = canvas.getContext("webgl");

const VERT_SRC = `
attribute vec2 aUV;
uniform sampler2D uDepth;
uniform mat4 uProj, uView;
uniform float uScale, uOffset, uAspect;
uniform float uDepthMin, uDepthMax;
varying vec2 vUV;
varying float vMask;
float decodeDepth(vec4 px) { return (px.r * 65536.0 + px.g * 256.0 + px.b) * 255.0 / 16777215.0; }
void main() {
  vUV = aUV;
  vec4 dpx = texture2D(uDepth, aUV);
  float d = decodeDepth(dpx);
  // min/max depth clipping (reference 3dviewer dmin/dmax sliders): remap the
  // selected range to 0..1, flattening everything outside onto the range ends
  d = clamp((d - uDepthMin) / max(uDepthMax - uDepthMin, 0.001), 0.0, 1.0);
  vMask = dpx.a;
  vec3 pos = vec3((aUV.x - 0.5) * uAspect, (0.5 - aUV.y), uScale * d + uOffset);
  gl_Position = uProj * uView * vec4(pos, 1.0);
}`;

const FRAG_SRC = `
precision mediump float;
uniform sampler2D uRGB;
uniform sampler2D uDepthF;
uniform float uUseMask;
uniform float uViewMode; // 0 = image texture, 1 = depth gray, 2 = depth spectral
uniform float uDepthMinF, uDepthMaxF;
uniform float uEdgeThresh; // 0 = off; else discard pixels whose depth gradient exceeds it
uniform vec2 uTexel;       // 1 / depth-texture size
varying vec2 vUV;
varying float vMask;
float decodeDepthF(vec4 px) { return (px.r * 65536.0 + px.g * 256.0 + px.b) * 255.0 / 16777215.0; }
vec3 spectral(float t) {
  // compact 5-stop approximation of the spectral colormap (blue->cyan->green->yellow->red)
  vec3 c0 = vec3(0.37, 0.31, 0.64), c1 = vec3(0.40, 0.76, 0.65), c2 = vec3(1.00, 1.00, 0.75);
  vec3 c3 = vec3(0.96, 0.43, 0.26), c4 = vec3(0.62, 0.00, 0.26);
  if (t < 0.25) return mix(c0, c1, t * 4.0);
  if (t < 0.50) return mix(c1, c2, (t - 0.25) * 4.0);
  if (t < 0.75) return mix(c2, c3, (t - 0.50) * 4.0);
  return mix(c3, c4, (t - 0.75) * 4.0);
}
void main() {
  if (uUseMask > 0.5 && vMask < 0.5) discard;
  if (uEdgeThresh > 0.0) {
    // interactive depth-edge cut (reference 3dviewer "Edge Threshold"):
    // central-difference gradient of the decoded depth, tunable client-side
    // without re-serving frames (the server's Sobel alpha is the precomputed
    // default; this refines it per-pixel)
    float dl = decodeDepthF(texture2D(uDepthF, vUV - vec2(uTexel.x, 0.0)));
    float dr = decodeDepthF(texture2D(uDepthF, vUV + vec2(uTexel.x, 0.0)));
    float du = decodeDepthF(texture2D(uDepthF, vUV - vec2(0.0, uTexel.y)));
    float dd = decodeDepthF(texture2D(uDepthF, vUV + vec2(0.0, uTexel.y)));
    if (abs(dr - dl) + abs(dd - du) > uEdgeThresh) discard;
  }
  if (uViewMode < 0.5) {
    gl_FragColor = vec4(texture2D(uRGB, vUV).rgb, 1.0);
  } else {
    float d = decodeDepthF(texture2D(uDepthF, vUV));
    d = clamp((d - uDepthMinF) / max(uDepthMaxF - uDepthMinF, 0.001), 0.0, 1.0);
    gl_FragColor = (uViewMode < 1.5) ? vec4(vec3(d), 1.0) : vec4(spectral(1.0 - d), 1.0);
  }
}`;

// wireframe program for the capture-frustum overlay
const LINE_VERT_SRC = `
attribute vec3 aPos;
uniform mat4 uProj, uView;
void main() { gl_Position = uProj * uView * vec4(aPos, 1.0); }`;
const LINE_FRAG_SRC = `
precision mediump float;
uniform vec3 uColor;
void main() { gl_FragColor = vec4(uColor, 1.0); }`;

function compile(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) throw new Error(gl.getShaderInfoLog(s));
  return s;
}
const program = gl.createProgram();
gl.attachShader(program, compile(gl.VERTEX_SHADER, VERT_SRC));
gl.attachShader(program, compile(gl.FRAGMENT_SHADER, FRAG_SRC));
gl.linkProgram(program);
gl.useProgram(program);

// dense plane mesh in UV space; density is user-adjustable (reference
// mesh.js exposes the same control)
let GRID = 320;
let uvs, indices;
gl.getExtension("OES_element_index_uint");
const uvBuf = gl.createBuffer();
const idxBuf = gl.createBuffer();
const aUV = gl.getAttribLocation(program, "aUV");
gl.enableVertexAttribArray(aUV);

function buildGrid(n) {
  GRID = n;
  uvs = new Float32Array((n + 1) * (n + 1) * 2);
  let p = 0;
  for (let y = 0; y <= n; y++) for (let x = 0; x <= n; x++) { uvs[p++] = x / n; uvs[p++] = y / n; }
  indices = new Uint32Array(n * n * 6);
  p = 0;
  for (let y = 0; y < n; y++) for (let x = 0; x < n; x++) {
    const i0 = y * (n + 1) + x, i1 = i0 + 1, i2 = i0 + n + 1, i3 = i2 + 1;
    indices[p++] = i0; indices[p++] = i2; indices[p++] = i1;
    indices[p++] = i1; indices[p++] = i2; indices[p++] = i3;
  }
  gl.bindBuffer(gl.ARRAY_BUFFER, uvBuf);
  gl.bufferData(gl.ARRAY_BUFFER, uvs, gl.STATIC_DRAW);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, idxBuf);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, indices, gl.STATIC_DRAW);
  gl.vertexAttribPointer(aUV, 2, gl.FLOAT, false, 0, 0);
}
buildGrid(GRID);

// frustum wireframe resources
const lineProgram = gl.createProgram();
gl.attachShader(lineProgram, compile(gl.VERTEX_SHADER, LINE_VERT_SRC));
gl.attachShader(lineProgram, compile(gl.FRAGMENT_SHADER, LINE_FRAG_SRC));
gl.linkProgram(lineProgram);
const lineBuf = gl.createBuffer();
const aLinePos = gl.getAttribLocation(lineProgram, "aPos");

function frustumLineVerts(aspect, A, B) {
  // the volume swept by the displacement mapping: near rect at z = B
  // (depth 0), far rect at z = A + B (depth 1), plus connecting edges
  const hx = aspect / 2, hy = 0.5, z0 = B, z1 = A + B;
  const n = [[-hx, -hy, z0], [hx, -hy, z0], [hx, hy, z0], [-hx, hy, z0]];
  const f = [[-hx, -hy, z1], [hx, -hy, z1], [hx, hy, z1], [-hx, hy, z1]];
  const edges = [];
  for (let i = 0; i < 4; i++) {
    edges.push(n[i], n[(i + 1) % 4]);   // near rectangle
    edges.push(f[i], f[(i + 1) % 4]);   // far rectangle
    edges.push(n[i], f[i]);             // connectors
  }
  return new Float32Array(edges.flat());
}

function makeTexture(unit) {
  const t = gl.createTexture();
  gl.activeTexture(gl.TEXTURE0 + unit);
  gl.bindTexture(gl.TEXTURE_2D, t);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
  return t;
}
const rgbTex = makeTexture(0);
const depthTex = makeTexture(1);
gl.uniform1i(gl.getUniformLocation(program, "uRGB"), 0);
gl.uniform1i(gl.getUniformLocation(program, "uDepth"), 1);
gl.uniform1i(gl.getUniformLocation(program, "uDepthF"), 1);
gl.enable(gl.DEPTH_TEST);

// vertex shader can't filter NEAREST-decoded 24-bit depth across byte
// boundaries safely with LINEAR; use NEAREST for depth
gl.activeTexture(gl.TEXTURE1);
gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.NEAREST);
gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.NEAREST);

// ---------------------------------------------------------------------------
// App state
const state = {
  yaw: 0, pitch: 0, dist: 1.6, target: [0, 0, 0.3],
  aspect: 1.0, frameIdx: 0, playing: false, sourceInfo: null,
  depthData: null, depthW: 0, depthH: 0, rgbImage: null, maskData: null,
};

const ui = {
  scale: document.getElementById("dispScale"),
  offset: document.getElementById("dispOffset"),
  fov: document.getElementById("fov"),
  useMask: document.getElementById("useMask"),
  showFrustum: document.getElementById("showFrustum"),
  viewMode: document.getElementById("viewMode"),
  meshDensity: document.getElementById("meshDensity"),
  depthMin: document.getElementById("depthMin"),
  depthMax: document.getElementById("depthMax"),
  edgeThresh: document.getElementById("edgeThresh"),
  playback: document.getElementById("playback"),
  resScale: document.getElementById("resScale"),
  status: document.getElementById("status"),
};
function syncLabels() {
  document.getElementById("scaleVal").textContent = ui.scale.value;
  document.getElementById("offsetVal").textContent = ui.offset.value;
  document.getElementById("fovVal").textContent = ui.fov.value;
  document.getElementById("depthMinVal").textContent = ui.depthMin.value;
  document.getElementById("depthMaxVal").textContent = ui.depthMax.value;
}
["input", "change"].forEach((ev) => {
  ui.scale.addEventListener(ev, syncLabels);
  ui.offset.addEventListener(ev, syncLabels);
  ui.fov.addEventListener(ev, syncLabels);
  ui.depthMin.addEventListener(ev, syncLabels);
  ui.depthMax.addEventListener(ev, syncLabels);
});
syncLabels();

// orbit controls
const HOME = { yaw: 0, pitch: 0, dist: 1.6, target: [0, 0, 0.3] };
function resetView() {
  state.yaw = HOME.yaw; state.pitch = HOME.pitch;
  state.dist = HOME.dist; state.target = HOME.target.slice();
}
let dragging = false, panning = false, lastXY = [0, 0];
canvas.addEventListener("mousedown", (e) => { dragging = true; panning = e.shiftKey; lastXY = [e.clientX, e.clientY]; });
canvas.addEventListener("dblclick", () => resetView());
window.addEventListener("keydown", (e) => {
  // keyboard orbit/zoom (reference orbitcam.js key controls): arrows orbit,
  // +/- zoom, R resets. Focused form controls keep their native keys.
  const tag = (document.activeElement || {}).tagName;
  if (tag === "INPUT" || tag === "SELECT" || tag === "TEXTAREA") return;
  const step = e.shiftKey ? 0.15 : 0.05;
  if (e.key === "ArrowLeft") state.yaw += step;
  else if (e.key === "ArrowRight") state.yaw -= step;
  else if (e.key === "ArrowUp") state.pitch = Math.min(1.5, state.pitch + step);
  else if (e.key === "ArrowDown") state.pitch = Math.max(-1.5, state.pitch - step);
  else if (e.key === "+" || e.key === "=") state.dist = Math.max(0.2, state.dist * 0.9);
  else if (e.key === "-") state.dist = Math.min(8, state.dist * 1.1);
  else if (e.key === "r" || e.key === "R") resetView();
  else return;
  e.preventDefault();
});
window.addEventListener("mouseup", () => { dragging = false; });
window.addEventListener("mousemove", (e) => {
  if (!dragging) return;
  const dx = e.clientX - lastXY[0], dy = e.clientY - lastXY[1];
  lastXY = [e.clientX, e.clientY];
  if (panning) {
    state.target[0] -= dx * 0.002 * state.dist;
    state.target[1] += dy * 0.002 * state.dist;
  } else {
    state.yaw -= dx * 0.005;
    state.pitch = Math.max(-1.5, Math.min(1.5, state.pitch + dy * 0.005));
  }
});
canvas.addEventListener("wheel", (e) => {
  state.dist = Math.max(0.2, Math.min(8, state.dist * (e.deltaY > 0 ? 1.1 : 0.9)));
  e.preventDefault();
}, { passive: false });

// ---------------------------------------------------------------------------
// Frame fetching / decoding
let fetchGen = 0; // serializes concurrent fetches (fast scrubbing): only the
                  // newest request is allowed to touch textures/state, so an
                  // out-of-order response can't leave the display on a stale frame
async function fetchFrame(idx) {
  const gen = ++fetchGen;
  const resp = await fetch(`/frame/${idx}`);
  if (!resp.ok) throw new Error(`frame fetch failed: ${resp.status}`);
  const rgbSize = parseInt(resp.headers.get("X-rgb-size"));
  const buf = await resp.arrayBuffer();
  const rgbBlob = new Blob([buf.slice(0, rgbSize)], { type: "image/jpeg" });
  const depthBlob = new Blob([buf.slice(rgbSize)], { type: "image/png" });
  const [rgbBmp, depthBmp] = await Promise.all([createImageBitmap(rgbBlob), createImageBitmap(depthBlob)]);
  if (gen !== fetchGen) return; // superseded by a newer request while decoding

  // upload rgb texture
  gl.activeTexture(gl.TEXTURE0);
  gl.bindTexture(gl.TEXTURE_2D, rgbTex);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGB, gl.RGB, gl.UNSIGNED_BYTE, rgbBmp);

  // upload packed depth texture (RGBA, decoded in the vertex shader)
  gl.activeTexture(gl.TEXTURE1);
  gl.bindTexture(gl.TEXTURE_2D, depthTex);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, gl.RGBA, gl.UNSIGNED_BYTE, depthBmp);

  // keep a CPU-side float copy for mesh export
  const c = document.createElement("canvas");
  c.width = depthBmp.width; c.height = depthBmp.height;
  const ctx = c.getContext("2d");
  ctx.drawImage(depthBmp, 0, 0);
  const img = ctx.getImageData(0, 0, c.width, c.height);
  const depth = new Float32Array(c.width * c.height);
  const mask = new Uint8Array(c.width * c.height);
  for (let i = 0; i < depth.length; i++) {
    const r = img.data[i * 4], g = img.data[i * 4 + 1], b = img.data[i * 4 + 2];
    depth[i] = (r * 65536 + g * 256 + b) / 16777215;
    mask[i] = img.data[i * 4 + 3];
  }
  state.depthData = depth; state.maskData = mask;
  state.depthW = c.width; state.depthH = c.height;
  state.rgbImage = rgbBmp;
  state.aspect = rgbBmp.width / rgbBmp.height;
}

// ---------------------------------------------------------------------------
// Render loop
function render() {
  // render-resolution scale (reference "Display Resolution" slider): the
  // canvas backing store shrinks while CSS keeps it full-window
  const res = parseFloat(ui.resScale.value);
  canvas.width = Math.max(64, Math.round(window.innerWidth * res));
  canvas.height = Math.max(64, Math.round(window.innerHeight * res));
  canvas.style.width = window.innerWidth + "px";
  canvas.style.height = window.innerHeight + "px";
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.06, 0.06, 0.07, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  if (state.depthData) {
    const proj = matPerspective((ui.fov.value * Math.PI) / 180, canvas.width / canvas.height, 0.01, 50);
    const view = matLookAtOrbit(state.dist, state.yaw, state.pitch, state.target);
    const A = parseFloat(ui.scale.value), B = parseFloat(ui.offset.value);

    gl.useProgram(program);
    gl.bindBuffer(gl.ARRAY_BUFFER, uvBuf);
    gl.enableVertexAttribArray(aUV);
    gl.vertexAttribPointer(aUV, 2, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, idxBuf);
    gl.uniformMatrix4fv(gl.getUniformLocation(program, "uProj"), false, proj);
    gl.uniformMatrix4fv(gl.getUniformLocation(program, "uView"), false, view);
    gl.uniform1f(gl.getUniformLocation(program, "uScale"), A);
    gl.uniform1f(gl.getUniformLocation(program, "uOffset"), B);
    gl.uniform1f(gl.getUniformLocation(program, "uAspect"), state.aspect);
    gl.uniform1f(gl.getUniformLocation(program, "uUseMask"), ui.useMask.checked ? 1 : 0);
    gl.uniform1f(gl.getUniformLocation(program, "uViewMode"), parseFloat(ui.viewMode.value));
    // the *F pair exists because the fragment stage is mediump (sharing one
    // uniform name across stages with different precision is a link error)
    const [dLo, dHi] = depthRange();
    gl.uniform1f(gl.getUniformLocation(program, "uDepthMin"), dLo);
    gl.uniform1f(gl.getUniformLocation(program, "uDepthMax"), dHi);
    gl.uniform1f(gl.getUniformLocation(program, "uDepthMinF"), dLo);
    gl.uniform1f(gl.getUniformLocation(program, "uDepthMaxF"), dHi);
    gl.uniform1f(gl.getUniformLocation(program, "uEdgeThresh"), parseFloat(ui.edgeThresh.value));
    gl.uniform2f(gl.getUniformLocation(program, "uTexel"), 1.0 / state.depthW, 1.0 / state.depthH);
    gl.drawElements(gl.TRIANGLES, indices.length, gl.UNSIGNED_INT, 0);

    if (ui.showFrustum.checked) {
      gl.useProgram(lineProgram);
      gl.bindBuffer(gl.ARRAY_BUFFER, lineBuf);
      gl.bufferData(gl.ARRAY_BUFFER, frustumLineVerts(state.aspect, A, B), gl.DYNAMIC_DRAW);
      gl.enableVertexAttribArray(aLinePos);
      gl.vertexAttribPointer(aLinePos, 3, gl.FLOAT, false, 0, 0);
      gl.uniformMatrix4fv(gl.getUniformLocation(lineProgram, "uProj"), false, proj);
      gl.uniformMatrix4fv(gl.getUniformLocation(lineProgram, "uView"), false, view);
      gl.uniform3f(gl.getUniformLocation(lineProgram, "uColor"), 0.4, 0.75, 1.0);
      gl.drawArrays(gl.LINES, 0, 24);
    }
  }
  requestAnimationFrame(render);
}

// video playback loop + scrubber (reference 3dviewer playback_slider):
// dragging seeks via the server's random-access /frame/N; playback keeps the
// slider in sync; the control only shows for multi-frame sources
let scrubbing = false;
function syncScrubber(info) {
  const row = document.getElementById("playbackRow");
  if (!info || info.frame_count <= 1) { row.style.display = "none"; return; }
  row.style.display = "";
  ui.playback.max = String(info.frame_count - 1);
  if (!scrubbing) ui.playback.value = String(state.frameIdx);
}
// pointerdown sets the flag; a document-level pointerup clears it — relying
// on the slider's 'change' event alone would leave scrubbing stuck true (and
// playback frozen) when the user releases without a net value change
ui.playback.addEventListener("pointerdown", () => { scrubbing = true; });
document.addEventListener("pointerup", () => { scrubbing = false; });
document.addEventListener("pointercancel", () => { scrubbing = false; });
ui.playback.addEventListener("input", async () => {
  state.frameIdx = parseInt(ui.playback.value, 10) || 0;
  try {
    await fetchFrame(state.frameIdx);
    ui.status.textContent = `frame ${state.frameIdx}`;
  } catch (e) { ui.status.textContent = String(e); }
});

async function playbackLoop() {
  while (true) {
    const info = state.sourceInfo;
    const delay = info && info.fps > 0 ? 1000 / info.fps : 100;
    if (state.playing && !scrubbing && info && info.type !== "image") {
      state.frameIdx = info.frame_count > 0 ? (state.frameIdx + 1) % info.frame_count : state.frameIdx + 1;
      try {
        await fetchFrame(state.frameIdx);
        ui.status.textContent = `frame ${state.frameIdx}`;
      } catch (e) { ui.status.textContent = String(e); }
    }
    syncScrubber(info);
    await new Promise((r) => setTimeout(r, delay));
  }
}

// ---------------------------------------------------------------------------
// Mesh export (positions + uvs + indices, sampled at GRID resolution)
// min/max depth clipping: remap the selected range to 0..1, clamped — shared
// semantics between the vertex shader and the export path (and mirrored by
// the server-side exporter, demo_helpers/mesh_export.py)
function depthRange() {
  const lo = parseFloat(ui.depthMin.value), hi = parseFloat(ui.depthMax.value);
  return lo < hi ? [lo, hi] : [hi, lo];
}
function remapDepth(d) {
  const r = depthRange();
  return Math.min(1, Math.max(0, (d - r[0]) / Math.max(r[1] - r[0], 0.001)));
}

function buildMeshArrays() {
  const n = (GRID + 1) * (GRID + 1);
  const positions = new Float32Array(n * 3);
  const A = parseFloat(ui.scale.value), B = parseFloat(ui.offset.value);
  for (let y = 0; y <= GRID; y++) for (let x = 0; x <= GRID; x++) {
    const i = y * (GRID + 1) + x;
    const u = x / GRID, v = y / GRID;
    const px = Math.min(state.depthW - 1, Math.round(u * (state.depthW - 1)));
    const py = Math.min(state.depthH - 1, Math.round(v * (state.depthH - 1)));
    const d = remapDepth(state.depthData[py * state.depthW + px]);
    positions[i * 3] = (u - 0.5) * state.aspect;
    positions[i * 3 + 1] = 0.5 - v;
    positions[i * 3 + 2] = A * d + B;
  }
  return { positions, uvs, indices };
}

function download(name, blob) {
  const a = document.createElement("a");
  a.href = URL.createObjectURL(blob);
  a.download = name;
  a.click();
}

function exportOBJ() {
  if (!state.depthData) return;
  const { positions, uvs, indices } = buildMeshArrays();
  const lines = ["# muggled_dpt_tpu depth mesh"];
  for (let i = 0; i < positions.length; i += 3)
    lines.push(`v ${positions[i].toFixed(5)} ${positions[i + 1].toFixed(5)} ${positions[i + 2].toFixed(5)}`);
  for (let i = 0; i < uvs.length; i += 2)
    lines.push(`vt ${uvs[i].toFixed(5)} ${(1 - uvs[i + 1]).toFixed(5)}`);
  for (let i = 0; i < indices.length; i += 3) {
    const a = indices[i] + 1, b = indices[i + 1] + 1, c = indices[i + 2] + 1;
    lines.push(`f ${a}/${a} ${b}/${b} ${c}/${c}`);
  }
  download("depth_mesh.obj", new Blob([lines.join("\n")], { type: "text/plain" }));
}

function exportGLB() {
  if (!state.depthData) return;
  const { positions, uvs: uvArr, indices: idxArr } = buildMeshArrays();
  // binary buffer: positions | uvs | indices (4-byte aligned)
  const posBytes = positions.byteLength, uvBytes = uvArr.byteLength, idxBytes = idxArr.byteLength;
  const binLen = posBytes + uvBytes + idxBytes;
  const bin = new ArrayBuffer(binLen + ((4 - (binLen % 4)) % 4));
  new Float32Array(bin, 0, positions.length).set(positions);
  new Float32Array(bin, posBytes, uvArr.length).set(uvArr);
  new Uint32Array(bin, posBytes + uvBytes, idxArr.length).set(idxArr);

  let minP = [1e9, 1e9, 1e9], maxP = [-1e9, -1e9, -1e9];
  for (let i = 0; i < positions.length; i += 3)
    for (let k = 0; k < 3; k++) {
      minP[k] = Math.min(minP[k], positions[i + k]);
      maxP[k] = Math.max(maxP[k], positions[i + k]);
    }

  const gltf = {
    asset: { version: "2.0", generator: "muggled_dpt_tpu" },
    scene: 0,
    scenes: [{ nodes: [0] }],
    nodes: [{ mesh: 0 }],
    meshes: [{ primitives: [{ attributes: { POSITION: 0, TEXCOORD_0: 1 }, indices: 2 }] }],
    accessors: [
      { bufferView: 0, componentType: 5126, count: positions.length / 3, type: "VEC3", min: minP, max: maxP },
      { bufferView: 1, componentType: 5126, count: uvArr.length / 2, type: "VEC2" },
      { bufferView: 2, componentType: 5125, count: idxArr.length, type: "SCALAR" },
    ],
    bufferViews: [
      { buffer: 0, byteOffset: 0, byteLength: posBytes },
      { buffer: 0, byteOffset: posBytes, byteLength: uvBytes },
      { buffer: 0, byteOffset: posBytes + uvBytes, byteLength: idxBytes },
    ],
    buffers: [{ byteLength: bin.byteLength }],
  };
  let jsonStr = JSON.stringify(gltf);
  while (jsonStr.length % 4 !== 0) jsonStr += " ";
  const jsonBytes = new TextEncoder().encode(jsonStr);

  const total = 12 + 8 + jsonBytes.length + 8 + bin.byteLength;
  const out = new ArrayBuffer(total);
  const dv = new DataView(out);
  let o = 0;
  dv.setUint32(o, 0x46546c67, true); o += 4;          // 'glTF'
  dv.setUint32(o, 2, true); o += 4;
  dv.setUint32(o, total, true); o += 4;
  dv.setUint32(o, jsonBytes.length, true); o += 4;
  dv.setUint32(o, 0x4e4f534a, true); o += 4;          // 'JSON'
  new Uint8Array(out, o).set(jsonBytes); o += jsonBytes.length;
  dv.setUint32(o, bin.byteLength, true); o += 4;
  dv.setUint32(o, 0x004e4942, true); o += 4;          // 'BIN'
  new Uint8Array(out, o).set(new Uint8Array(bin));
  download("depth_mesh.glb", new Blob([out], { type: "model/gltf-binary" }));
}

// ---------------------------------------------------------------------------
// Wire up
document.getElementById("playBtn").addEventListener("click", (e) => {
  state.playing = !state.playing;
  e.target.textContent = state.playing ? "pause" : "play";
});
document.getElementById("exportObj").addEventListener("click", exportOBJ);
document.getElementById("exportGlb").addEventListener("click", exportGLB);
ui.meshDensity.addEventListener("change", () => buildGrid(parseInt(ui.meshDensity.value)));

// info/help overlay
const infoOverlay = document.getElementById("infoOverlay");
function toggleInfo(show) {
  const visible = show !== undefined ? show : infoOverlay.style.display === "none";
  infoOverlay.style.display = visible ? "block" : "none";
  if (visible && state.sourceInfo) {
    const i = state.sourceInfo;
    document.getElementById("infoSource").textContent =
      `source: ${i.type}` + (i.frame_count > 1 ? ` · ${i.frame_count} frames @ ${i.fps} fps` : "") +
      (i.name ? ` · ${i.name}` : "");
  }
}
document.getElementById("infoBtn").addEventListener("click", (e) => { e.stopPropagation(); toggleInfo(); });
infoOverlay.addEventListener("click", () => toggleInfo(false));
window.addEventListener("keydown", (e) => { if (e.key === "?") toggleInfo(); });
document.getElementById("uploadBtn").addEventListener("click", () => document.getElementById("upload").click());
document.getElementById("upload").addEventListener("change", async (e) => {
  const file = e.target.files[0];
  if (!file) return;
  ui.status.textContent = "uploading...";
  await fetch("/upload", { method: "POST", body: await file.arrayBuffer() });
  state.sourceInfo = await (await fetch("/get-source-info")).json();
  await fetchFrame(0);
  ui.status.textContent = "uploaded";
});

(async function init() {
  try {
    state.sourceInfo = await (await fetch("/get-source-info")).json();
    await fetchFrame(0);
    ui.status.textContent = `${state.sourceInfo.type} loaded` +
      (state.sourceInfo.frame_count > 1 ? ` (${state.sourceInfo.frame_count} frames)` : "");
  } catch (e) {
    ui.status.textContent = String(e);
  }
  render();
  playbackLoop();
})();
