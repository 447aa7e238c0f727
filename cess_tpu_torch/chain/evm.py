"""EVM execution pallet: contract accounts, gas, and a full-featured
interpreter over the frontier-era opcode set.

Capability match: the reference gets EVM compatibility from the forked
Frontier — `pallet_evm` + `pallet_ethereum` wired at
runtime/src/lib.rs:1322-1344 with the standard precompile set
(runtime/src/precompiles.rs:23-53) and eth RPC served by the node
(node/src/rpc.rs:179-323).  This pallet is a native re-implementation of
the execution capability against the framework's deterministic
ChainState:

 * **Account model.**  20-byte H160 addresses; EVM balances live in the
   pallet ledger, bridged to the chain's native balances through the
   `evm-pot` account (`deposit`/`withdraw` — the role of Frontier's
   AddressMapping + withdraw adapter).  A native account's mapped
   address is keccak256("cess-evm:" ‖ name)[12:].

 * **Execution.**  A 256-bit stack machine implementing the arithmetic,
   comparison, keccak, environment, block-context, memory, storage,
   control-flow, logging, and system opcode families (CREATE/CREATE2/
   CALL/DELEGATECALL/STATICCALL/RETURN/REVERT/SELFDESTRUCT), with
   EIP-150-style 63/64 gas forwarding, call-depth limit 1024, value
   transfers, and full state journaling (storage, balances, nonces,
   code, logs roll back on revert/failure).

 * **Precompiles** at the standard addresses: 0x01 ecrecover,
   0x02 sha256, 0x04 identity, 0x05 modexp.

 * **Gas.**  A simplified-but-shaped schedule (constant-tier opcode
   costs, quadratic memory expansion, keccak/copy per-word costs,
   cold-SSTORE surcharge, 21000 intrinsic tx cost).  Fees =
   gas_used × gas_price are charged from the caller's EVM balance and
   credited to the block author's pot via on_fee.

What is deliberately out of scope (recorded, not omitted silently):
secp256k1 tx signatures (extrinsics arrive through the framework's
BLS-signed envelope; ecrecover remains available to contracts), the
ancient difficulty/DIFFICULTY semantics (PREVRANDAO serves the chain's
shared randomness), and fee-market EIP-1559 dynamics (flat gas_price).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..utils.keccak import keccak256
from .state import ChainState
from .types import AccountId, Balance, DispatchError, ensure

MOD = "evm"

EVM_POT = "evm-pot"  # native-side escrow for the EVM ledger
CHAIN_ID = 11330  # the CESS testnet EVM chain id
CALL_DEPTH_LIMIT = 1024
MAX_CODE_SIZE = 24576  # EIP-170

U256 = (1 << 256) - 1
_SIGN_BIT = 1 << 255


def _to_signed(x: int) -> int:
    return x - (1 << 256) if x & _SIGN_BIT else x


def _addr(x: int) -> bytes:
    return (x & ((1 << 160) - 1)).to_bytes(20, "big")


def _rlp(item) -> bytes:
    """Minimal RLP encode (bytes or nested lists) — CREATE addressing."""
    if isinstance(item, bytes):
        if len(item) == 1 and item[0] < 0x80:
            return item
        if len(item) <= 55:
            return bytes([0x80 + len(item)]) + item
        ln = len(item).to_bytes((len(item).bit_length() + 7) // 8, "big")
        return bytes([0xB7 + len(ln)]) + ln + item
    payload = b"".join(_rlp(x) for x in item)
    if len(payload) <= 55:
        return bytes([0xC0 + len(payload)]) + payload
    ln = len(payload).to_bytes((len(payload).bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(ln)]) + ln + payload


def _int_bytes(x: int) -> bytes:
    return b"" if x == 0 else x.to_bytes((x.bit_length() + 7) // 8, "big")


def create_address(sender: bytes, nonce: int) -> bytes:
    return keccak256(_rlp([sender, _int_bytes(nonce)]))[12:]


def create2_address(sender: bytes, salt: bytes, init_code: bytes) -> bytes:
    return keccak256(b"\xff" + sender + salt + keccak256(init_code))[12:]


# ------------------------------------------------------------ secp256k1

_SECP_P = 2**256 - 2**32 - 977
_SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_SECP_G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


def _secp_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % _SECP_P == 0:
        return None
    if p == q:
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, _SECP_P) % _SECP_P
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, _SECP_P) % _SECP_P
    x = (lam * lam - p[0] - q[0]) % _SECP_P
    return (x, (lam * (p[0] - x) - p[1]) % _SECP_P)


def _secp_mul(k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = _secp_add(acc, p)
        p = _secp_add(p, p)
        k >>= 1
    return acc


def ecrecover(msg_hash: bytes, v: int, r: int, s: int) -> bytes | None:
    """Recover the signer's address (the 0x01 precompile)."""
    if not (1 <= r < _SECP_N and 1 <= s < _SECP_N and v in (27, 28)):
        return None
    x = r
    y_sq = (pow(x, 3, _SECP_P) + 7) % _SECP_P
    y = pow(y_sq, (_SECP_P + 1) // 4, _SECP_P)
    if y * y % _SECP_P != y_sq:
        return None
    if (y & 1) != (v - 27):
        y = _SECP_P - y
    z = int.from_bytes(msg_hash, "big")
    r_inv = pow(r, -1, _SECP_N)
    # Q = r^-1 (s·R − z·G)
    sR = _secp_mul(s, (x, y))
    zG = _secp_mul(z % _SECP_N, _SECP_G)
    neg_zG = None if zG is None else (zG[0], (-zG[1]) % _SECP_P)
    q = _secp_mul(r_inv, _secp_add(sR, neg_zG))
    if q is None:
        return None
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return keccak256(pub)[12:]


# ------------------------------------------------------------ data model


@dataclass
class EvmAccount:
    nonce: int = 0
    code: bytes = b""


@dataclass
class Log:
    address: bytes
    topics: list[bytes]
    data: bytes


@dataclass
class ExecResult:
    success: bool
    return_data: bytes
    gas_used: int
    logs: list[Log] = field(default_factory=list)
    contract: bytes | None = None  # CREATE target
    error: str = ""


class _Revert(Exception):
    def __init__(self, data: bytes = b""):
        self.data = data


class _Fail(Exception):
    """Exceptional halt: consumes all frame gas (out-of-gas, bad jump,
    stack violation, static-state violation…)."""

    def __init__(self, reason: str):
        self.reason = reason


# simplified gas schedule (constant tiers)
G_VERYLOW, G_LOW, G_MID, G_BASE, G_HIGH = 3, 5, 8, 2, 10
G_KECCAK, G_KECCAK_WORD = 30, 6
G_SLOAD, G_SSTORE_SET, G_SSTORE_RESET = 100, 20000, 5000
G_LOG, G_LOG_TOPIC, G_LOG_DATA = 375, 375, 8
G_CREATE, G_CALL, G_CALL_VALUE, G_NEW_ACCOUNT = 32000, 100, 9000, 25000
G_COPY_WORD, G_EXP, G_EXP_BYTE = 3, 10, 50
G_TX = 21000
G_CODE_DEPOSIT = 200  # per byte of deployed runtime code


class EvmPallet:
    def __init__(self, state: ChainState, block_time_ms: int = 6000) -> None:
        self.state = state
        self.block_time_ms = block_time_ms
        self.accounts: dict[bytes, EvmAccount] = {}
        self.storage: dict[tuple[bytes, int], int] = {}
        self.balances: dict[bytes, int] = {}
        # fees accrue here; the runtime's fee split can drain it
        self.fee_pot: int = 0

    # ------------------------------------------------------ address map

    @staticmethod
    def address_of(account: AccountId) -> bytes:
        """Native account → H160 (the AddressMapping role)."""
        return keccak256(b"cess-evm:" + account.encode())[12:]

    # ------------------------------------------------------ bridge

    def deposit(self, sender: AccountId, amount: Balance) -> bytes:
        """Move native balance into the sender's mapped EVM address."""
        ensure(amount > 0, MOD, "ZeroAmount")
        self.state.balances.transfer(sender, EVM_POT, amount)
        addr = self.address_of(sender)
        self.balances[addr] = self.balances.get(addr, 0) + amount
        self.state.deposit_event(
            MOD, "Deposit", who=sender, address=addr.hex(), amount=amount
        )
        return addr

    def withdraw(self, sender: AccountId, amount: Balance) -> None:
        addr = self.address_of(sender)
        ensure(
            self.balances.get(addr, 0) >= amount, MOD, "BalanceLow"
        )
        self.balances[addr] -= amount
        self.state.balances.transfer(EVM_POT, sender, amount)
        self.state.deposit_event(
            MOD, "Withdraw", who=sender, address=addr.hex(), amount=amount
        )

    # ------------------------------------------------------ tx entry

    def transact_call(
        self,
        sender: AccountId,
        to: bytes,
        data: bytes = b"",
        value: int = 0,
        gas_limit: int = 1_000_000,
        gas_price: int = 1,
    ) -> ExecResult:
        """Signed-extrinsic entry (pallet_evm::call role): charge the
        intrinsic cost + fee from the mapped address, execute, refund."""
        return self._transact(
            sender, to, data, value, gas_limit, gas_price, create=False
        )

    def transact_create(
        self,
        sender: AccountId,
        init_code: bytes,
        value: int = 0,
        gas_limit: int = 1_000_000,
        gas_price: int = 1,
    ) -> ExecResult:
        return self._transact(
            sender, init_code, b"", value, gas_limit, gas_price, create=True
        )

    def _transact(
        self, sender, target, data, value, gas_limit, gas_price, create
    ) -> ExecResult:
        caller = self.address_of(sender)
        ensure(gas_limit >= G_TX, MOD, "GasLimitTooLow")
        fee_max = gas_limit * gas_price
        ensure(
            self.balances.get(caller, 0) >= fee_max + value,
            MOD, "BalanceLow",
        )
        self.balances[caller] -= fee_max
        acct = self.accounts.setdefault(caller, EvmAccount())
        nonce = acct.nonce
        acct.nonce += 1
        gas = gas_limit - G_TX
        if create:
            res = self.create(
                caller, target, value=value, gas=gas, nonce=nonce
            )
        else:
            res = self.call(caller, target, data=data, value=value, gas=gas)
        gas_used = res.gas_used + G_TX
        refund = (gas_limit - gas_used) * gas_price
        self.balances[caller] = self.balances.get(caller, 0) + refund
        self.fee_pot += gas_used * gas_price
        res = ExecResult(
            res.success, res.return_data, gas_used, res.logs,
            res.contract, res.error,
        )
        self.state.deposit_event(
            MOD,
            "Executed" if res.success else "ExecutedFailed",
            who=sender,
            to=(res.contract or (target if not create else b"")).hex()
            if isinstance(res.contract or target, bytes) else "",
            gas_used=gas_used,
        )
        return res

    # ------------------------------------------------------ raw entry

    def call(
        self,
        caller: bytes,
        to: bytes,
        data: bytes = b"",
        value: int = 0,
        gas: int = 1_000_000,
    ) -> ExecResult:
        """Message call from `caller` (already an H160)."""
        snap = self._snapshot()
        logs: list[Log] = []
        try:
            ret, gas_left = self._call_frame(
                caller, to, data, value, gas, logs, static=False, depth=0
            )
            return ExecResult(True, ret, gas - gas_left, logs)
        except _Revert as rv:
            self._restore(snap)
            return ExecResult(False, rv.data, gas, error="revert")
        except _Fail as f:
            self._restore(snap)
            return ExecResult(False, b"", gas, error=f.reason)

    def create(
        self,
        caller: bytes,
        init_code: bytes,
        value: int = 0,
        gas: int = 1_000_000,
        nonce: int | None = None,
        salt: bytes | None = None,
    ) -> ExecResult:
        snap = self._snapshot()
        logs: list[Log] = []
        try:
            if nonce is None:
                acct = self.accounts.setdefault(caller, EvmAccount())
                nonce = acct.nonce
                acct.nonce += 1  # CREATE addressing consumes the nonce
            addr, gas_left = self._create_frame(
                caller, init_code, value, gas, logs, depth=0, salt=salt,
                nonce=nonce,
            )
            return ExecResult(True, b"", gas - gas_left, logs, contract=addr)
        except _Revert as rv:
            self._restore(snap)
            return ExecResult(False, rv.data, gas, error="revert")
        except _Fail as f:
            self._restore(snap)
            return ExecResult(False, b"", gas, error=f.reason)

    # ------------------------------------------------------ journaling

    def _snapshot(self):
        return (
            dict(self.storage),
            dict(self.balances),
            {a: EvmAccount(ac.nonce, ac.code) for a, ac in self.accounts.items()},
        )

    def _restore(self, snap) -> None:
        self.storage, self.balances, self.accounts = (
            dict(snap[0]), dict(snap[1]),
            {a: EvmAccount(ac.nonce, ac.code) for a, ac in snap[2].items()},
        )

    # ------------------------------------------------------ frames

    def _transfer(self, frm: bytes, to: bytes, value: int) -> None:
        if value == 0:
            return
        if self.balances.get(frm, 0) < value:
            raise _Fail("insufficient balance")
        self.balances[frm] -= value
        self.balances[to] = self.balances.get(to, 0) + value

    def _create_frame(
        self, caller, init_code, value, gas, logs, depth,
        salt=None, nonce=0,
    ):
        if depth > CALL_DEPTH_LIMIT:
            raise _Fail("call depth")
        if salt is not None:
            addr = create2_address(caller, salt, init_code)
        else:
            addr = create_address(caller, nonce)
        if self.accounts.get(addr, EvmAccount()).code:
            raise _Fail("address collision")
        self._transfer(caller, addr, value)
        acct = self.accounts.setdefault(addr, EvmAccount())
        acct.nonce = 1
        ret, gas_left = self._execute(
            caller=caller, address=addr, code=init_code, data=b"",
            value=value, gas=gas, logs=logs, static=False, depth=depth,
        )
        if len(ret) > MAX_CODE_SIZE:
            raise _Fail("code too large")
        deposit = G_CODE_DEPOSIT * len(ret)
        if gas_left < deposit:
            raise _Fail("out of gas: code deposit")
        acct.code = bytes(ret)
        return addr, gas_left - deposit

    def _call_frame(
        self, caller, to, data, value, gas, logs, static, depth,
        code_addr=None, ctx_addr=None,
    ):
        """Run a message call; returns (return_data, gas_left).  Raises
        _Revert/_Fail (caller handles sub-call containment)."""
        if depth > CALL_DEPTH_LIMIT:
            raise _Fail("call depth")
        if static and value:
            raise _Fail("static value transfer")
        ctx = ctx_addr if ctx_addr is not None else to
        if ctx_addr is None:  # regular CALL moves value
            self._transfer(caller, to, value)
        pre = self._precompile(code_addr or to, data)
        if pre is not None:
            cost, out = pre
            if cost > gas:
                raise _Fail("out of gas: precompile")
            return out, gas - cost
        code = self.accounts.get(code_addr or to, EvmAccount()).code
        if not code:
            return b"", gas
        return self._execute(
            caller=caller, address=ctx, code=code, data=data, value=value,
            gas=gas, logs=logs, static=static, depth=depth,
        )

    # ------------------------------------------------------ precompiles

    def _precompile(self, addr: bytes, data: bytes):
        which = int.from_bytes(addr, "big")
        if not 1 <= which <= 9:
            return None
        if which == 1:  # ecrecover
            buf = data.ljust(128, b"\x00")[:128]
            h, v = buf[0:32], int.from_bytes(buf[32:64], "big")
            r = int.from_bytes(buf[64:96], "big")
            s = int.from_bytes(buf[96:128], "big")
            rec = ecrecover(h, v, r, s)
            out = b"" if rec is None else rec.rjust(32, b"\x00")
            return 3000, out
        if which == 2:  # sha256
            words = -(-len(data) // 32)
            return 60 + 12 * words, hashlib.sha256(data).digest()
        if which == 4:  # identity
            words = -(-len(data) // 32)
            return 15 + 3 * words, data
        if which == 5:  # modexp (EIP-198 shape, simplified gas)
            buf = data.ljust(96, b"\x00")
            bl = int.from_bytes(buf[0:32], "big")
            el = int.from_bytes(buf[32:64], "big")
            ml = int.from_bytes(buf[64:96], "big")
            if max(bl, el, ml) > 4096:
                return None  # unpriceable: treat as empty account
            rest = data[96:].ljust(bl + el + ml, b"\x00")
            b = int.from_bytes(rest[:bl], "big")
            e = int.from_bytes(rest[bl : bl + el], "big")
            m = int.from_bytes(rest[bl + el : bl + el + ml], "big")
            out = (pow(b, e, m) if m else 0).to_bytes(ml, "big")
            cost = 200 + max(bl, ml) * max(el.bit_length(), 1) // 8
            return cost, out
        return None  # unimplemented slots behave as empty accounts

    # ------------------------------------------------------ interpreter

    def _execute(
        self, *, caller, address, code, data, value, gas, logs, static,
        depth,
    ):
        stack: list[int] = []
        mem = bytearray()
        pc = 0
        gas_left = gas
        ret_data = b""  # RETURNDATA buffer
        jumpdests = _jumpdests(code)

        def use(n: int) -> None:
            nonlocal gas_left
            gas_left -= n
            if gas_left < 0:
                raise _Fail("out of gas")

        def mem_expand(offset: int, size: int) -> None:
            if size == 0:
                return
            need = offset + size
            if need > len(mem):
                old_w = len(mem) // 32
                new_w = -(-need // 32)
                use(
                    3 * (new_w - old_w)
                    + (new_w * new_w - old_w * old_w) // 512
                )
                mem.extend(b"\x00" * (new_w * 32 - len(mem)))

        def push(x: int) -> None:
            if len(stack) >= 1024:
                raise _Fail("stack overflow")
            stack.append(x & U256)

        def pop() -> int:
            if not stack:
                raise _Fail("stack underflow")
            return stack.pop()

        def mload(off: int, size: int) -> bytes:
            mem_expand(off, size)
            return bytes(mem[off : off + size])

        while pc < len(code):
            op = code[pc]
            pc += 1

            # PUSH0..PUSH32
            if 0x5F <= op <= 0x7F:
                n = op - 0x5F
                use(G_BASE if n == 0 else G_VERYLOW)
                push(int.from_bytes(code[pc : pc + n], "big"))
                pc += n
                continue
            # DUP1..DUP16
            if 0x80 <= op <= 0x8F:
                use(G_VERYLOW)
                i = op - 0x7F
                if len(stack) < i:
                    raise _Fail("stack underflow")
                push(stack[-i])
                continue
            # SWAP1..SWAP16
            if 0x90 <= op <= 0x9F:
                use(G_VERYLOW)
                i = op - 0x8F
                if len(stack) < i + 1:
                    raise _Fail("stack underflow")
                stack[-1], stack[-1 - i] = stack[-1 - i], stack[-1]
                continue
            # LOG0..LOG4
            if 0xA0 <= op <= 0xA4:
                if static:
                    raise _Fail("static log")
                n_topics = op - 0xA0
                off, size = pop(), pop()
                topics = [pop().to_bytes(32, "big") for _ in range(n_topics)]
                use(G_LOG + G_LOG_TOPIC * n_topics + G_LOG_DATA * size)
                logs.append(Log(address, topics, mload(off, size)))
                continue

            if op == 0x00:  # STOP
                return b"", gas_left
            elif op == 0x01:  # ADD
                use(G_VERYLOW); push(pop() + pop())
            elif op == 0x02:  # MUL
                use(G_LOW); push(pop() * pop())
            elif op == 0x03:  # SUB
                use(G_VERYLOW); a = pop(); push(a - pop())
            elif op == 0x04:  # DIV
                use(G_LOW); a, b = pop(), pop(); push(a // b if b else 0)
            elif op == 0x05:  # SDIV
                use(G_LOW)
                a, b = _to_signed(pop()), _to_signed(pop())
                push(0 if b == 0 else abs(a) // abs(b) * (1 if a * b >= 0 else -1))
            elif op == 0x06:  # MOD
                use(G_LOW); a, b = pop(), pop(); push(a % b if b else 0)
            elif op == 0x07:  # SMOD
                use(G_LOW)
                a, b = _to_signed(pop()), _to_signed(pop())
                push(0 if b == 0 else abs(a) % abs(b) * (1 if a >= 0 else -1))
            elif op == 0x08:  # ADDMOD
                use(G_MID); a, b, n = pop(), pop(), pop()
                push((a + b) % n if n else 0)
            elif op == 0x09:  # MULMOD
                use(G_MID); a, b, n = pop(), pop(), pop()
                push(a * b % n if n else 0)
            elif op == 0x0A:  # EXP
                a, e = pop(), pop()
                use(G_EXP + G_EXP_BYTE * ((e.bit_length() + 7) // 8))
                push(pow(a, e, 1 << 256))
            elif op == 0x0B:  # SIGNEXTEND
                use(G_LOW)
                k, x = pop(), pop()
                if k < 31:
                    bit = 8 * (k + 1) - 1
                    if x & (1 << bit):
                        x |= U256 ^ ((1 << (bit + 1)) - 1)
                    else:
                        x &= (1 << (bit + 1)) - 1
                push(x)
            elif op == 0x10:  # LT
                use(G_VERYLOW); a = pop(); push(1 if a < pop() else 0)
            elif op == 0x11:  # GT
                use(G_VERYLOW); a = pop(); push(1 if a > pop() else 0)
            elif op == 0x12:  # SLT
                use(G_VERYLOW)
                a = _to_signed(pop()); push(1 if a < _to_signed(pop()) else 0)
            elif op == 0x13:  # SGT
                use(G_VERYLOW)
                a = _to_signed(pop()); push(1 if a > _to_signed(pop()) else 0)
            elif op == 0x14:  # EQ
                use(G_VERYLOW); push(1 if pop() == pop() else 0)
            elif op == 0x15:  # ISZERO
                use(G_VERYLOW); push(1 if pop() == 0 else 0)
            elif op == 0x16:  # AND
                use(G_VERYLOW); push(pop() & pop())
            elif op == 0x17:  # OR
                use(G_VERYLOW); push(pop() | pop())
            elif op == 0x18:  # XOR
                use(G_VERYLOW); push(pop() ^ pop())
            elif op == 0x19:  # NOT
                use(G_VERYLOW); push(~pop())
            elif op == 0x1A:  # BYTE
                use(G_VERYLOW); i, x = pop(), pop()
                push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:  # SHL
                use(G_VERYLOW); s, x = pop(), pop()
                push(x << s if s < 256 else 0)
            elif op == 0x1C:  # SHR
                use(G_VERYLOW); s, x = pop(), pop()
                push(x >> s if s < 256 else 0)
            elif op == 0x1D:  # SAR
                use(G_VERYLOW); s, x = pop(), _to_signed(pop())
                push(x >> s if s < 256 else (0 if x >= 0 else U256))
            elif op == 0x20:  # KECCAK256
                off, size = pop(), pop()
                use(G_KECCAK + G_KECCAK_WORD * (-(-size // 32)))
                push(int.from_bytes(keccak256(mload(off, size)), "big"))
            elif op == 0x30:  # ADDRESS
                use(G_BASE); push(int.from_bytes(address, "big"))
            elif op == 0x31:  # BALANCE
                use(G_SLOAD); push(self.balances.get(_addr(pop()), 0))
            elif op == 0x32:  # ORIGIN (≈ caller of the outer frame)
                use(G_BASE); push(int.from_bytes(caller, "big"))
            elif op == 0x33:  # CALLER
                use(G_BASE); push(int.from_bytes(caller, "big"))
            elif op == 0x34:  # CALLVALUE
                use(G_BASE); push(value)
            elif op == 0x35:  # CALLDATALOAD
                use(G_VERYLOW); off = pop()
                push(int.from_bytes(data[off : off + 32].ljust(32, b"\x00"), "big"))
            elif op == 0x36:  # CALLDATASIZE
                use(G_BASE); push(len(data))
            elif op == 0x37:  # CALLDATACOPY
                doff, off, size = pop(), pop(), pop()
                use(G_VERYLOW + G_COPY_WORD * (-(-size // 32)))
                mem_expand(doff, size)
                chunk = data[off : off + size].ljust(size, b"\x00")
                mem[doff : doff + size] = chunk
            elif op == 0x38:  # CODESIZE
                use(G_BASE); push(len(code))
            elif op == 0x39:  # CODECOPY
                doff, off, size = pop(), pop(), pop()
                use(G_VERYLOW + G_COPY_WORD * (-(-size // 32)))
                mem_expand(doff, size)
                chunk = code[off : off + size].ljust(size, b"\x00")
                mem[doff : doff + size] = chunk
            elif op == 0x3A:  # GASPRICE
                use(G_BASE); push(1)
            elif op == 0x3B:  # EXTCODESIZE
                use(G_SLOAD)
                push(len(self.accounts.get(_addr(pop()), EvmAccount()).code))
            elif op == 0x3C:  # EXTCODECOPY
                a, doff, off, size = pop(), pop(), pop(), pop()
                use(G_SLOAD + G_COPY_WORD * (-(-size // 32)))
                mem_expand(doff, size)
                xc = self.accounts.get(_addr(a), EvmAccount()).code
                mem[doff : doff + size] = xc[off : off + size].ljust(size, b"\x00")
            elif op == 0x3D:  # RETURNDATASIZE
                use(G_BASE); push(len(ret_data))
            elif op == 0x3E:  # RETURNDATACOPY
                doff, off, size = pop(), pop(), pop()
                use(G_VERYLOW + G_COPY_WORD * (-(-size // 32)))
                if off + size > len(ret_data):
                    raise _Fail("returndata out of bounds")
                mem_expand(doff, size)
                mem[doff : doff + size] = ret_data[off : off + size]
            elif op == 0x3F:  # EXTCODEHASH
                use(G_SLOAD)
                acct = self.accounts.get(_addr(pop()))
                push(
                    0 if acct is None
                    else int.from_bytes(keccak256(acct.code), "big")
                )
            elif op == 0x40:  # BLOCKHASH
                use(G_BASE * 10); pop(); push(0)
            elif op == 0x41:  # COINBASE
                use(G_BASE); push(0)
            elif op == 0x42:  # TIMESTAMP
                use(G_BASE)
                push(self.state.block_number * self.block_time_ms // 1000)
            elif op == 0x43:  # NUMBER
                use(G_BASE); push(self.state.block_number)
            elif op == 0x44:  # PREVRANDAO (the chain's shared randomness)
                use(G_BASE)
                push(int.from_bytes(self.state.randomness[:32], "big"))
            elif op == 0x45:  # GASLIMIT
                use(G_BASE); push(30_000_000)
            elif op == 0x46:  # CHAINID
                use(G_BASE); push(CHAIN_ID)
            elif op == 0x47:  # SELFBALANCE
                use(G_LOW); push(self.balances.get(address, 0))
            elif op == 0x48:  # BASEFEE
                use(G_BASE); push(1)
            elif op == 0x50:  # POP
                use(G_BASE); pop()
            elif op == 0x51:  # MLOAD
                use(G_VERYLOW); off = pop()
                push(int.from_bytes(mload(off, 32), "big"))
            elif op == 0x52:  # MSTORE
                use(G_VERYLOW); off, val = pop(), pop()
                mem_expand(off, 32)
                mem[off : off + 32] = val.to_bytes(32, "big")
            elif op == 0x53:  # MSTORE8
                use(G_VERYLOW); off, val = pop(), pop()
                mem_expand(off, 1)
                mem[off] = val & 0xFF
            elif op == 0x54:  # SLOAD
                use(G_SLOAD)
                push(self.storage.get((address, pop()), 0))
            elif op == 0x55:  # SSTORE
                if static:
                    raise _Fail("static sstore")
                slot, val = pop(), pop()
                cur = self.storage.get((address, slot), 0)
                use(
                    G_SSTORE_SET if cur == 0 and val != 0
                    else G_SSTORE_RESET
                )
                if val:
                    self.storage[(address, slot)] = val
                else:
                    self.storage.pop((address, slot), None)
            elif op == 0x56:  # JUMP
                use(G_MID); dest = pop()
                if dest not in jumpdests:
                    raise _Fail("bad jump")
                pc = dest + 1
            elif op == 0x57:  # JUMPI
                use(G_HIGH); dest, cond = pop(), pop()
                if cond:
                    if dest not in jumpdests:
                        raise _Fail("bad jump")
                    pc = dest + 1
            elif op == 0x58:  # PC
                use(G_BASE); push(pc - 1)
            elif op == 0x59:  # MSIZE
                use(G_BASE); push(len(mem))
            elif op == 0x5A:  # GAS
                use(G_BASE); push(gas_left)
            elif op == 0x5B:  # JUMPDEST
                use(1)
            elif op in (0xF0, 0xF5):  # CREATE / CREATE2
                if static:
                    raise _Fail("static create")
                val = pop(); off = pop(); size = pop()
                salt = pop().to_bytes(32, "big") if op == 0xF5 else None
                use(G_CREATE)
                init = mload(off, size)
                child_gas = gas_left - gas_left // 64
                use(child_gas)
                snap = self._snapshot()
                sub_logs: list[Log] = []
                try:
                    me = self.accounts.setdefault(address, EvmAccount())
                    my_nonce = me.nonce
                    me.nonce += 1
                    new_addr, sub_left = self._create_frame(
                        address, init, val, child_gas, sub_logs,
                        depth + 1, salt=salt, nonce=my_nonce,
                    )
                    logs.extend(sub_logs)
                    gas_left += sub_left
                    ret_data = b""
                    push(int.from_bytes(new_addr, "big"))
                except _Revert as rv:
                    self._restore(snap)
                    ret_data = rv.data
                    push(0)
                except _Fail:
                    self._restore(snap)
                    ret_data = b""
                    push(0)
            elif op in (0xF1, 0xF4, 0xFA):  # CALL/DELEGATECALL/STATICCALL
                req_gas = pop()
                to = _addr(pop())
                val = pop() if op == 0xF1 else 0
                in_off, in_size = pop(), pop()
                out_off, out_size = pop(), pop()
                cost = G_CALL
                if val:
                    cost += G_CALL_VALUE
                    if to not in self.accounts and to not in self.balances:
                        cost += G_NEW_ACCOUNT
                use(cost)
                arg = mload(in_off, in_size)
                mem_expand(out_off, out_size)
                avail = gas_left - gas_left // 64
                child_gas = min(req_gas, avail)
                use(child_gas)
                if val:
                    child_gas += 2300  # value-call stipend
                snap = self._snapshot()
                sub_logs = []
                try:
                    if op == 0xF4:  # DELEGATECALL: callee code, our ctx
                        out, sub_left = self._call_frame(
                            caller, address, arg, value, child_gas,
                            sub_logs, static, depth + 1,
                            code_addr=to, ctx_addr=address,
                        )
                    elif op == 0xFA:  # STATICCALL
                        out, sub_left = self._call_frame(
                            address, to, arg, 0, child_gas, sub_logs,
                            True, depth + 1,
                        )
                    else:
                        out, sub_left = self._call_frame(
                            address, to, arg, val, child_gas, sub_logs,
                            static, depth + 1,
                        )
                    logs.extend(sub_logs)
                    gas_left += sub_left
                    ret_data = out
                    mem[out_off : out_off + out_size] = out[:out_size].ljust(
                        out_size, b"\x00"
                    )
                    push(1)
                except _Revert as rv:
                    self._restore(snap)
                    ret_data = rv.data
                    mem[out_off : out_off + out_size] = rv.data[
                        :out_size
                    ].ljust(out_size, b"\x00")
                    push(0)
                except _Fail:
                    self._restore(snap)
                    ret_data = b""
                    push(0)
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                return mload(off, size), gas_left
            elif op == 0xFD:  # REVERT
                off, size = pop(), pop()
                raise _Revert(mload(off, size))
            elif op == 0xFE:  # INVALID
                raise _Fail("invalid opcode")
            elif op == 0xFF:  # SELFDESTRUCT
                if static:
                    raise _Fail("static selfdestruct")
                use(5000)
                heir = _addr(pop())
                bal = self.balances.pop(address, 0)
                if bal:
                    self.balances[heir] = self.balances.get(heir, 0) + bal
                self.accounts.pop(address, None)
                return b"", gas_left
            else:
                raise _Fail(f"unknown opcode 0x{op:02x}")
        return b"", gas_left


def _jumpdests(code: bytes) -> frozenset[int]:
    """Valid JUMPDEST offsets (PUSH immediates are not destinations)."""
    out = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            out.add(i)
        i += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return frozenset(out)
