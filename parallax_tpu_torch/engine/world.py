"""World: bodies + shapes + pair table + joints on one device.

``World.build`` turns host-side body definitions into the static pair
table and float32 parameter tensors, and moves every static table the
batched step reads (vertex tables, lane-to-body indices, the contact
kernel's operands) to ``device`` (the GPU unless the caller asks for the
CPU) once.  The batched step itself is
``engine.batched.physics_core``.  The per-world path runs on states with
leading batch axes (the port of the JAX package's ``jax.vmap`` over one
world): ``World.detect_contacts`` (``engine.collider.collide``, under
either narrow phase) and ``World.step``, the reference's step order:

    1. integrate positions from velocities
    2. apply gravity as a velocity kick
    3. detect and resolve contacts (the solver of ``solver_mode``)
    4. apply joint impulses

``integrator="symplectic"`` flips 1 and 2.  ``World.step`` is plain torch
on the world's device, as JAX's is XLA code: it reaches no kernel of the
repo.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from parallax_tpu_torch.dynamics.block_solver import solve_contacts as solve_contacts_block
from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.dynamics.impulses import DEFAULT_SOLVER, ContactSolverConfig
from parallax_tpu_torch.dynamics.integrator import (
    apply_acceleration,
    integrate_explicit_euler,
    movable_mask,
)
from parallax_tpu_torch.dynamics.joints import Joints, apply_joints
from parallax_tpu_torch.dynamics.solver import resolve_contacts
from parallax_tpu_torch.engine.collider import PairTable, build_pair_table, collide
from parallax_tpu_torch.engine.ref_replay import build_replay_plan, resolve_reference_keyed
from parallax_tpu_torch.geometry.contacts import Contact
from parallax_tpu_torch.geometry.shapes import Parts, ShapeSpec
from parallax_tpu_torch.utils.device import resolve as resolve_device


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Static world configuration.

    ``narrowphase="gjk_epa"`` and every ``solver_mode`` but ``"block"`` run
    on the per-world ``World.step``; the batched step refuses them, as the
    JAX package's does.  ``relaxation``, ``joint_mode`` and
    ``joint_iterations`` are the per-world step's."""

    dt: float = 0.01
    gravity: tuple = (0.0, 0.0)
    integrator: str = "reference"  # "reference" | "symplectic"
    narrowphase: str = "sat"  # "sat" | "gjk_epa"; the batched path runs "sat" only
    # AABB broad-phase pre-mask on the polygon pair groups
    broadphase: bool = True
    # block | jacobi | gauss_seidel | random_one_per_body |
    # random_one_per_body_keyed (key-for-key replay of the reference
    # collider's PRNG tree, engine.ref_replay); the batched path runs
    # "block" only
    solver_mode: str = "block"
    solver_iterations: int = 4
    position_iterations: int = 3  # split-impulse passes (block mode only)
    relaxation: float = 1.0
    joint_mode: str = "gauss_seidel"
    joint_iterations: int = 1
    contact: ContactSolverConfig = DEFAULT_SOLVER
    # run the contact solve and the joints as the hand-written CUDA kernel
    # (ops/contact_solver.py) when the body planes are CUDA tensors; on CPU
    # tensors the plain torch version runs
    use_cuda_solver: bool = False
    # run the whole step (integrate, collide, solve, joints) as the fused
    # CUDA kernel (ops/fused_step.py), the twin of the JAX package's
    # use_pallas_fused; it takes precedence over use_cuda_solver.  Under
    # autograd its reverse-pass kernel is the backward.  On CUDA tensors a
    # world it does not run raises; on CPU tensors its plain version runs,
    # and autograd of it is the backward
    use_cuda_fused: bool = False


@dataclasses.dataclass
class BodyDef:
    """Host-side body description."""

    shapes: Sequence[ShapeSpec]
    mass: float = 1.0
    inertia: float = 1.0
    position: Sequence[float] = (0.0, 0.0)
    velocity: Sequence[float] = (0.0, 0.0)
    angle: float = 0.0
    angular_velocity: float = 0.0
    elasticity: float = 1.0
    friction: float = 1.0
    is_area: bool = False
    name: str = ""


@dataclasses.dataclass
class World:
    """Physics world over a fixed body/shape topology, on one device."""

    parts: Parts
    params: BodyParams
    joints: Joints
    config: WorldConfig
    table: PairTable
    static_bodies: tuple
    names: tuple
    device: torch.device
    # static device tables of the batched step, keyed by what they serve
    # (see ``static``); filled at build time
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_bodies(self) -> int:
        return len(self.static_bodies)

    def static(self, key, build: Callable):
        """The static table cached under ``key``, built by ``build()`` once."""
        if key not in self.cache:
            self.cache[key] = build()
        return self.cache[key]

    @staticmethod
    def build(
        bodies: Sequence[BodyDef],
        config: WorldConfig = WorldConfig(),
        joints: Optional[Joints] = None,
        collision_filter: Sequence[tuple] = (),
        part_collision_filter: Sequence[tuple] = (),
        device="cuda",
    ) -> tuple["World", BodyState]:
        device = resolve_device(device)
        specs, owner = [], []
        for i, b in enumerate(bodies):
            for s in b.shapes:
                specs.append(s)
                owner.append(i)
        parts = Parts.from_specs(specs, owner)

        static = tuple(not np.isfinite(b.mass) for b in bodies)
        areas = tuple(bool(b.is_area) for b in bodies)
        for i, b in enumerate(bodies):
            if b.angle != 0.0 and any(s.kind == 1 for s in b.shapes) and not static[i]:
                raise ValueError(
                    f"body {i}: box parts on rotating bodies are unsupported "
                    "(use a polygon part)"
                )
        table = build_pair_table(
            parts, static, areas, collision_filter,
            narrowphase=config.narrowphase,
            part_collision_filter=part_collision_filter,
        )

        def f32(values):
            return torch.tensor(np.asarray(values, np.float32), device=device)

        params = BodyParams(
            mass=f32([b.mass for b in bodies]),
            inertia=f32([b.inertia for b in bodies]),
            elasticity=f32([b.elasticity for b in bodies]),
            friction=f32([b.friction for b in bodies]),
        )
        state = BodyState(
            pos=f32([b.position for b in bodies]),
            vel=f32([b.velocity for b in bodies]),
            angle=f32([b.angle for b in bodies]),
            omega=f32([b.angular_velocity for b in bodies]),
        )
        world = World(
            parts=parts.to(device),
            params=params,
            joints=(joints if joints is not None else Joints.empty()).to(device),
            config=config,
            table=table,
            static_bodies=static,
            names=tuple(b.name for b in bodies),
            device=device,
        )
        from parallax_tpu_torch.engine.batched import build_static_tables

        build_static_tables(world)
        return world, state

    def world_parts(self, state: BodyState) -> Parts:
        """The parts in the world frame at ``state`` (``pos`` ``[..., n, 2]``,
        ``angle`` ``[..., n]``)."""
        return self.parts.to_world(state.pos, torch.cos(state.angle), torch.sin(state.angle))

    def detect_contacts(self, state: BodyState) -> Contact:
        """The contact buffer ``[..., C]`` of ``state``: every pair group's
        contact function under the world's narrow phase and broadphase
        (``engine.collider.collide``)."""
        return collide(
            self.world_parts(state),
            self.table,
            narrowphase=self.config.narrowphase,
            broadphase=self.config.broadphase,
        )

    def step(
        self,
        state: BodyState,
        key=None,
        dt: Optional[float] = None,
        accel=None,
    ) -> tuple[BodyState, Contact]:
        """One physics step of every world of ``state`` (``pos`` ``[.., n,
        2]``): ``(new_state, contacts)``, the contact buffer ``[.., C]``.

        ``key`` is ``[.., 2]``, one threefry key a world, read by the
        random solver modes (None: ``PRNGKey(0)`` in each world); ``accel``
        broadcasts against ``[.., n, 2]`` and adds to gravity.  The step
        is plain torch on the state's device: ``use_cuda_solver`` and
        ``use_cuda_fused`` serve ``engine.batched.step_batched`` only and
        have no effect here, as ``use_pallas_*`` in the JAX package.
        """
        cfg = self.config
        dt = cfg.dt if dt is None else dt
        grav = torch.tensor(cfg.gravity, dtype=state.vel.dtype, device=state.vel.device)
        if accel is not None:
            grav = grav + torch.as_tensor(accel, dtype=state.vel.dtype, device=state.vel.device)
        mov = movable_mask(self.params)

        if cfg.integrator == "symplectic":
            state = apply_acceleration(state, grav, dt, mov)
            state = integrate_explicit_euler(state, dt)
        else:  # reference order: positions first, then the gravity kick
            state = integrate_explicit_euler(state, dt)
            state = apply_acceleration(state, grav, dt, mov)

        contacts = self.detect_contacts(state)
        if cfg.solver_mode == "random_one_per_body_keyed":
            plan = build_replay_plan(self.parts.kind, self.parts.nverts, self.parts.body,
                                     self.n_bodies)
            state = resolve_reference_keyed(
                self.world_parts(state), state, self.params, plan, key, cfg.contact
            )
        elif cfg.solver_mode == "block":
            state = solve_contacts_block(
                state,
                self.params,
                contacts,
                np.asarray(self.table.body_a),
                np.asarray(self.table.body_b),
                np.asarray(self.table.partner),
                iterations=cfg.solver_iterations,
                position_iterations=cfg.position_iterations,
                dt=dt,
                config=cfg.contact,
            )
        else:
            state = resolve_contacts(
                state,
                self.params,
                contacts,
                np.asarray(self.table.body_a),
                np.asarray(self.table.body_b),
                mode=cfg.solver_mode,
                iterations=cfg.solver_iterations,
                relaxation=cfg.relaxation,
                key=key,
                config=cfg.contact,
            )
        state = apply_joints(
            state, self.params, self.joints, mode=cfg.joint_mode, iterations=cfg.joint_iterations
        )
        return state, contacts
